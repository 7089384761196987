"""Roofline terms of the port: the analytic FLOP, byte and collective
counts (``analytic``) and the H100's peaks with the HLO collective parser
(``analysis``)."""
