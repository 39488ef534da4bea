"""xgboost_tpu_torch.reliability: crash-safe persistence, failure
injection and deadlines (port of ``xgboost_tpu/reliability``):
:mod:`~.integrity` (atomic, CRC-footed model files), :mod:`~.faults`
(the ``XGBTPU_FAULTS`` / ``faults=`` registry whose seams are the real
read, write, reload and predict paths) and :mod:`~.deadline`
(``X-Deadline-Ms`` budgets, :func:`jittered`, :func:`backoff_delay`)."""

from xgboost_tpu_torch.reliability.deadline import (DEADLINE_HEADER,
                                                    Deadline,
                                                    DeadlineExceeded,
                                                    backoff_delay, jittered)
from xgboost_tpu_torch.reliability.faults import (InjectedFault,
                                                  clear_faults, inject,
                                                  install_spec)
from xgboost_tpu_torch.reliability.integrity import (ModelIntegrityError,
                                                     add_footer,
                                                     atomic_write,
                                                     quarantine, read_file,
                                                     verify_model_bytes)

__all__ = ["DEADLINE_HEADER", "Deadline", "DeadlineExceeded",
           "InjectedFault", "ModelIntegrityError", "add_footer",
           "atomic_write", "backoff_delay", "clear_faults", "inject",
           "install_spec", "jittered", "quarantine", "read_file",
           "verify_model_bytes"]
