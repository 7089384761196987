"""The port's twins of the reference's ``examples/``: each runs the
reference example's scenario through the port and checks itself (a
failed check raises).

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.store_coldstart_smoke [--device cpu]
    python -m repro_torch.examples.consolidation_demo [--device cpu]
    python -m repro_torch.examples.streaming_demo [--device cpu]

Each runs on the card unless ``--device cpu`` is given, at the
reference's smoke sizes (``configs.smoke_variant``: float32, head dim 16),
with weights drawn from a seeded ``torch.Generator``; each module's
``main(device=...)`` is the same run for a caller.
"""

from __future__ import annotations

import argparse


def cli_device(doc: str):
    """The ``--device`` of an example's command line (None: the card)."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args().device
