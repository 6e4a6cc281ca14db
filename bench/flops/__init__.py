"""Count formulas and peaks, frozen in the benchmark: the operations and
bytes an algorithm needs, whatever implements it."""
