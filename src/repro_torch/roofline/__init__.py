"""Roofline terms of the port's cells on the H100 (counterpart of
``repro.roofline``): ``hardware`` holds the card's constants, ``count``
counts one cell's step on the meta device, ``analysis`` turns the counts
into roofline terms, ``report`` prints the dry-run's artifacts."""
