"""`python -m shadow1_tpu_torch run CONFIG --data-directory DIR`."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
