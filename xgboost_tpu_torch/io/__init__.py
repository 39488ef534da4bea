"""Data loading dispatch (port of ``xgboost_tpu/io``)."""
