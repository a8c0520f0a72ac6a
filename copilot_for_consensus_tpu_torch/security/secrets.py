"""Secret providers.

Parity with the reference's ``copilot_secrets`` (ABC + local file provider +
cloud provider + factory). ``secret://name`` references inside configs are
resolved through one of these at config load time (core/config.py).
"""

from __future__ import annotations

import abc
import os
import pathlib
from typing import Callable, Mapping


class SecretNotFoundError(KeyError):
    pass


class SecretProvider(abc.ABC):
    @abc.abstractmethod
    def get_secret(self, name: str) -> str:
        """Return the secret value or raise SecretNotFoundError."""

    def __call__(self, name: str) -> str:
        return self.get_secret(name)


class LocalSecretProvider(SecretProvider):
    """Secrets as individual files in a directory (``secrets/<name>``)."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)

    def get_secret(self, name: str) -> str:
        if "/" in name or "\\" in name or name.startswith("."):
            raise SecretNotFoundError(name)
        path = self.root / name
        if not path.is_file():
            raise SecretNotFoundError(name)
        return path.read_text().strip()


class EnvSecretProvider(SecretProvider):
    """Secrets from ``COPILOT_SECRET_<NAME>`` environment variables."""

    def __init__(self, env: Mapping[str, str] | None = None):
        self.env = os.environ if env is None else env

    def get_secret(self, name: str) -> str:
        key = f"COPILOT_SECRET_{name.upper()}"
        if key not in self.env:
            raise SecretNotFoundError(name)
        return self.env[key]


class StaticSecretProvider(SecretProvider):
    """In-memory secrets for tests."""

    def __init__(self, values: Mapping[str, str]):
        self.values = dict(values)

    def get_secret(self, name: str) -> str:
        try:
            return self.values[name]
        except KeyError:
            raise SecretNotFoundError(name) from None


class ChainSecretProvider(SecretProvider):
    def __init__(self, *providers: SecretProvider):
        self.providers = providers

    def get_secret(self, name: str) -> str:
        for p in self.providers:
            try:
                return p.get_secret(name)
            except SecretNotFoundError:
                continue
        raise SecretNotFoundError(name)


def default_secret_resolver(env: Mapping[str, str] | None = None) -> Callable[[str], str]:
    """Env secrets first, then files under $COPILOT_SECRETS_DIR (or ./secrets)."""
    env = os.environ if env is None else env
    secrets_dir = env.get("COPILOT_SECRETS_DIR", "secrets")
    return ChainSecretProvider(
        EnvSecretProvider(env), LocalSecretProvider(secrets_dir)
    )


class AzureKeyVaultSecretProvider(SecretProvider):
    """Azure Key Vault secrets via raw REST — no SDK (reference
    ``copilot_secrets/azurekeyvault_provider.py`` rides the SDK).

    AAD client-credentials flow mints the bearer token
    (``POST {authority}/{tenant}/oauth2/v2.0/token``), cached until
    shortly before expiry; secrets read via
    ``GET {vault}/secrets/{name}?api-version=7.4``. ``authority`` and
    ``vault_url`` overrides point the provider at mocks/emulators —
    how ``tests/test_azure_drivers.py`` exercises the wire contract in
    this zero-egress image.
    """

    API_VERSION = "7.4"

    def __init__(self, vault_url: str, tenant_id: str, client_id: str,
                 client_secret: str,
                 authority: str = "https://login.microsoftonline.com",
                 timeout_s: float = 15.0):
        if not all((vault_url, tenant_id, client_id, client_secret)):
            raise ValueError(
                "azure_keyvault needs vault_url, tenant_id, client_id, "
                "client_secret")
        self.vault_url = vault_url.rstrip("/")
        self.tenant_id = tenant_id
        self.client_id = client_id
        self.client_secret = client_secret
        self.authority = authority.rstrip("/")
        self.timeout_s = timeout_s
        self._token: str | None = None
        self._token_exp = 0.0

    def _bearer(self) -> str:
        import json
        import time
        import urllib.parse
        import urllib.request

        if self._token and time.time() < self._token_exp - 60:
            return self._token
        scope = f"{self.vault_url}/.default"
        body = urllib.parse.urlencode({
            "grant_type": "client_credentials",
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "scope": scope,
        }).encode()
        req = urllib.request.Request(
            f"{self.authority}/{self.tenant_id}/oauth2/v2.0/token",
            data=body, method="POST",
            headers={"Content-Type":
                     "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            tok = json.loads(resp.read())
        self._token = tok["access_token"]
        self._token_exp = time.time() + float(tok.get("expires_in", 300))
        return self._token

    def get_secret(self, name: str) -> str:
        import json
        import urllib.error
        import urllib.request

        if not name or not all(
                (c.isascii() and c.isalnum()) or c == "-"
                for c in name):
            raise SecretNotFoundError(name)   # KV's own name charset
        try:
            bearer = self._bearer()
        except urllib.error.HTTPError as exc:
            raise RuntimeError(
                f"key vault token request failed: "
                f"HTTP {exc.code}") from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise RuntimeError(
                f"key vault token endpoint unreachable: {exc}") from exc
        req = urllib.request.Request(
            f"{self.vault_url}/secrets/{name}"
            f"?api-version={self.API_VERSION}",
            headers={"Authorization": f"Bearer {bearer}"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return str(json.loads(resp.read())["value"])
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise SecretNotFoundError(name) from exc
            raise RuntimeError(
                f"key vault GET {name} failed: HTTP {exc.code}") from exc
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise RuntimeError(
                f"key vault unreachable: {exc}") from exc


def create_secret_provider(config=None) -> SecretProvider:
    """Config-driven construction: env / local / static / chain-default
    / azure_keyvault."""
    cfg = dict(config or {})
    # 'env' stays the implicit default (the pre-r3 factory behavior):
    # silently adding the local-file fallback could resolve a stale
    # on-disk secret that the environment deliberately omits.
    driver = cfg.get("driver", "env")
    if driver == "default":
        if cfg.get("root"):
            return ChainSecretProvider(
                EnvSecretProvider(),
                LocalSecretProvider(cfg["root"]))
        # the SAME chain config-load-time secret:// resolution uses —
        # including its COPILOT_SECRETS_DIR handling
        return default_secret_resolver()
    if driver == "env":
        return EnvSecretProvider()
    if driver == "local":
        return LocalSecretProvider(cfg.get("root", "secrets"))
    if driver == "static":
        return StaticSecretProvider(cfg.get("values", {}))
    if driver == "azure_keyvault":
        return AzureKeyVaultSecretProvider(
            vault_url=cfg.get("vault_url", ""),
            tenant_id=cfg.get("tenant_id", ""),
            client_id=cfg.get("client_id", ""),
            client_secret=cfg.get("client_secret", ""),
            authority=cfg.get("authority",
                              "https://login.microsoftonline.com"))
    raise ValueError(f"unknown secrets driver {driver!r}")
