"""Security plane: secret providers, JWT signing/verification, OIDC.

Capability parity with the reference's ``copilot_secrets``,
``copilot_jwt_signer`` and ``copilot_auth`` adapter packages (SURVEY.md §2.1).
"""
