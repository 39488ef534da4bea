"""Entry point: ``python -m xgboost_tpu_torch <config> [name=value ...]``."""

import sys

from xgboost_tpu_torch.cli import main

sys.exit(main())
