"""Launch flags of the LM trainers, and what one GPU refuses.

usdm_tpu/core/distributed.py attaches multi-host flags to its train CLIs
and builds their device mesh.  The port trains on one GPU in one process:
the same flags parse, and `refuse_unported` raises NotImplementedError by
name for anything beyond one device (--dp or --tp > 1, a coordinator,
several processes or slices) until multi-GPU is ported (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

UNPORTED = "multi-GPU training is not ported to usdm_tpu_torch yet (ROADMAP Queue 1 item 10)"


def add_cli_args(p) -> None:
    """usdm_tpu's multi-host launch flags (parsed; refused beyond one process)."""
    g = p.add_argument_group("distributed (multi-host launch; not ported)")
    g.add_argument("--coordinator", default=None, help="rank-0 host:port (refused)")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total process count (refused above 1)")
    g.add_argument("--process_id", type=int, default=None, help="this host's rank")
    g.add_argument("--num_slices", type=int, default=1, help="multi-slice pods (refused above 1)")


def refuse_unported(args) -> None:
    """Raise NotImplementedError naming the flag when the command line asks
    for more than one device or process."""
    for flag, bad in (("--dp", getattr(args, "dp", 1) > 1), ("--tp", getattr(args, "tp", 1) > 1),
                      ("--coordinator", args.coordinator is not None),
                      ("--num_processes", (args.num_processes or 1) > 1),
                      ("--num_slices", args.num_slices > 1)):
        if bad:
            raise NotImplementedError(f"{flag}: {UNPORTED}")
