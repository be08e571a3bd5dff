import sys

from gpud_tpu_torch.cli import main

sys.exit(main())
