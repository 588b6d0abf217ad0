import sys

from coast_tpu_torch.analysis.json_parser import main

if __name__ == "__main__":
    sys.exit(main())
