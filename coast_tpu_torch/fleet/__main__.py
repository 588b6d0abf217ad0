"""``python -m coast_tpu_torch.fleet`` -- the fleet supervisor CLI."""

import sys

from coast_tpu_torch.fleet.supervisor import main

if __name__ == "__main__":
    sys.exit(main())
