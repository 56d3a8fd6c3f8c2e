"""CPU tests of the benchmark; card tests are marked ``card``."""
