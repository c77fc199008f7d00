"""One loop kind per file; ``traffic/<mix>.json`` names its driver."""
