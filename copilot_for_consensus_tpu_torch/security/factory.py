"""Driver registration for security adapters: secret providers, JWT
signers, OIDC providers."""

from __future__ import annotations


from copilot_for_consensus_tpu_torch.core.factory import register_driver
from copilot_for_consensus_tpu_torch.security.secrets import (
    create_secret_provider,
)

for _name in ("env", "local", "static", "default", "azure_keyvault"):
    register_driver("secret_provider", _name, create_secret_provider)

for _name in ("local_rs256", "hs256"):
    register_driver(
        "jwt_signer", _name,
        "copilot_for_consensus_tpu_torch.security.jwt:create_jwt_signer")

for _name in ("github", "google", "microsoft", "datatracker", "mock"):
    register_driver(
        "oidc_provider", _name,
        "copilot_for_consensus_tpu_torch.security.auth:create_oidc_provider")
