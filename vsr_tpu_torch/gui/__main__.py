"""``python -m vsr_tpu_torch.gui`` — launch the browser GUI."""

import sys

from vsr_tpu_torch.gui.server import main

if __name__ == "__main__":
    sys.exit(main())
