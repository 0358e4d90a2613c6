"""``python -m grmonty_tpu_torch``: the command line (:func:`cli.main`)."""

import sys

from grmonty_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
