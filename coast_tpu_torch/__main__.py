"""``python -m coast_tpu_torch <verb>``: the port's top-level entry point.

One stable spelling for the user-facing verbs, so operators do not need
to know the module layout (the reference's verbs, in its order):

    python -m coast_tpu_torch ci ...        # protection-regression CI
    python -m coast_tpu_torch profile ...   # campaign attribution report
    python -m coast_tpu_torch slo ...       # reliability SLO check/report
    python -m coast_tpu_torch serve ...     # protected inference service
    python -m coast_tpu_torch fleet ...     # campaign fleet (alias)
    python -m coast_tpu_torch analysis ...  # log analysis (alias)
    python -m coast_tpu_torch opt ...       # protect + run one program

Each verb forwards to its module CLI unchanged, which runs on the card
unless given ``-d cpu`` / ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip(), file=sys.stderr)
        return 0 if argv else 2
    verb, rest = argv[0], argv[1:]
    if verb == "ci":
        from coast_tpu_torch.ci.__main__ import main as ci_main
        return ci_main(rest)
    if verb == "profile":
        from coast_tpu_torch.obs.profile_cli import main as profile_main
        return profile_main(rest)
    if verb == "slo":
        from coast_tpu_torch.obs.slo_cli import main as slo_main
        return slo_main(rest)
    if verb == "serve":
        from coast_tpu_torch.serve.front import main as serve_main
        return serve_main(rest)
    if verb == "fleet":
        from coast_tpu_torch.fleet.supervisor import main as fleet_main
        return fleet_main(rest)
    if verb == "analysis":
        from coast_tpu_torch.analysis.json_parser import main as an_main
        return an_main(rest)
    if verb == "opt":
        from coast_tpu_torch.opt import main as opt_main
        return opt_main(rest)
    print(f"Error, unknown verb {verb!r}; want one of: ci, profile, "
          "slo, serve, fleet, analysis, opt "
          "(see python -m coast_tpu_torch --help)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
