"""Plain versions of the operations of the reference model."""
