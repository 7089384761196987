"""Frozen copies of the arithmetic the benchmark measures with: arrivals
and lengths, the card's peaks and the roofline bound, model FLOPs and
attention bytes. Nothing here imports the program."""
