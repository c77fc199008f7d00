"""The parts of a run that every cell shares."""
