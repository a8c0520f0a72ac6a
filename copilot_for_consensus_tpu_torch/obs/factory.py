"""Driver registration for observability adapters."""

from copilot_for_consensus_tpu_torch.core.factory import register_driver

register_driver("logger", "stdout", "copilot_for_consensus_tpu_torch.obs.logging:create_logger")
register_driver("logger", "silent", "copilot_for_consensus_tpu_torch.obs.logging:create_logger")
register_driver("logger", "memory", "copilot_for_consensus_tpu_torch.obs.logging:create_logger")
register_driver("logger", "shipping", "copilot_for_consensus_tpu_torch.obs.logging:create_logger")

for _name in ("noop", "inmemory", "prometheus", "pushgateway"):
    register_driver("metrics", _name,
                    "copilot_for_consensus_tpu_torch.obs.metrics:create_metrics_collector")

for _name in ("console", "silent", "collecting", "http"):
    register_driver("error_reporter", _name,
                    "copilot_for_consensus_tpu_torch.obs.errors:create_error_reporter")
