"""Pipeline services (reference: the 8 microservices of SURVEY.md §2.2).

Each service is a class subscribing to bus events and publishing
downstream events, owning its adapters — the same shape as the
reference's ``{service}/app/service.py`` classes. They are process-
agnostic: the in-proc runner (``services/runner.py``) wires all of them
onto one broker for single-host runs and tests; production deployments
give each its own process + bus connection (service ``main`` bootstrap in
``services/bootstrap.py``).
"""

from copilot_for_consensus_tpu_torch.services.base import BaseService
from copilot_for_consensus_tpu_torch.services.runner import Pipeline, build_pipeline

__all__ = ["BaseService", "Pipeline", "build_pipeline"]
