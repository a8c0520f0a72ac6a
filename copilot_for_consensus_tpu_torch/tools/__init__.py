"""Operator tooling (reference: ``scripts/`` — failed-queue CLI,
retry-stuck-documents job)."""
