"""Building blocks of the reference model."""
