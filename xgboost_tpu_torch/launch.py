"""Alias: ``python -m xgboost_tpu_torch.launch`` is the gang launcher
(:mod:`xgboost_tpu_torch.parallel.launch`)."""

import sys

from xgboost_tpu_torch.parallel.launch import main

if __name__ == "__main__":
    sys.exit(main())
