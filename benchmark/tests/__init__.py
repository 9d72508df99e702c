"""CPU tests of the benchmark (and one end-to-end test on the card)."""
