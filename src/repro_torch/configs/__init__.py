"""Model configurations (verbatim copies of the reference's `configs/`)."""
