"""``python -m tpufeat_torch`` == ``python -m tpufeat_torch.cli``."""
import sys

from tpufeat_torch.cli import main

sys.exit(main())
