"""Counting and roofline terms of the port's programs on the H100
(``count``: FLOPs, bytes, collectives and peak memory of one rank's ops;
``analysis``: the three roofline terms and the model FLOPs)."""
