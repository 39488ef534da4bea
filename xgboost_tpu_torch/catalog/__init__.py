"""xgboost_tpu_torch.catalog: the multi-model catalog of a serving
replica (port of ``xgboost_tpu/catalog``).

:class:`ModelCatalog` holds N named models, each an independent
:class:`~xgboost_tpu_torch.serving.registry.ModelRegistry` with its own
bucket graphs, hot-reload poll, micro-batcher and optional feature store,
admitted under one shared device-memory budget with LRU eviction and a
hysteresis window; every server is a catalog server, a model path alone
a catalog of one.  :func:`parse_manifest` reads the ``catalog=`` (and
``lanes=``) ``name=path`` manifests.  The router's per-tenant quotas
(``TenantQuotas``) stay with the fleet (ROADMAP.md section 1 item 14b).
"""

from xgboost_tpu_torch.catalog.catalog import (CatalogEntry, ModelCatalog,
                                               UnknownModel, parse_manifest)

__all__ = ["CatalogEntry", "ModelCatalog", "UnknownModel", "parse_manifest"]
