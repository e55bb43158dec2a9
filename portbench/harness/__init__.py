"""What every cell shares: finding a cell's files, seeds and weights, the
traced window and its reading, the output check's arithmetic, and the run
that ties them together."""
