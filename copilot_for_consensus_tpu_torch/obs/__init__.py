"""Observability plane: structured logging, metrics, error reporting, health.

Capability parity with the reference's ``copilot_logging``,
``copilot_metrics`` and ``copilot_error_reporting`` packages (SURVEY.md §2.1,
§5 "Metrics / logging / observability").
"""
