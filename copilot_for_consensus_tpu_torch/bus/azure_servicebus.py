"""Azure Service Bus bus driver — REST API, no SDK.

Fills the role of the reference's SDK-based publisher/subscriber pair
(``copilot_message_bus/azureservicebuspublisher.py:30``,
``copilot_message_bus/azureservicebussubscriber.py:29``) with the
documented Service Bus HTTP wire protocol and stdlib HTTP only, in the
style of this repo's other Azure drivers (Blob/Key Vault/Cosmos): the
same requests work against real Azure, the emulator, or the in-process
wire-contract mock in ``tests/test_azure_servicebus.py``.

Topology (the repo's bus contract, ``bus/base.py``):

* ONE topic plays the exchange role; every envelope is sent to it with
  the routing key stamped both as the message ``Label`` (subject) and a
  ``routing_key`` custom property.
* one subscription per (group, routing key), created on demand with a
  SQL rule ``routing_key = '<rk>'`` — the server-side filtering the
  reference provisions in Bicep (rule ``EventTypeFilter``,
  ``infra/azure/modules/servicebus.bicep`` via
  ``tests/infra/azure/test_servicebus_filters.py:115``). Subscribers
  sharing a ``group`` name share the subscription and compete;
  distinct groups each see every message.
* consume is peek-lock: callback ok → DELETE (complete); callback
  raising → PUT (abandon, redelivery); the subscription's
  ``MaxDeliveryCount = max_redeliveries + 1`` makes the BROKER move
  poisoned messages to ``$DeadLetterQueue`` — the same at-least-once +
  DLQ contract as the first-party broker driver (``bus/broker.py``).
* locks expire server-side after ``lock_duration_s``; a renewal thread
  POSTs the lock URI at half-life while the callback runs (the SDK's
  ``AutoLockRenewer`` role) so slow handlers don't get redelivered.

Auth is SAS (SharedAccessSignature over the namespace URI) — the
documented HMAC-SHA256 scheme; tokens are minted per request window and
cached until near expiry.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

_LOG = logging.getLogger(__name__)

from copilot_for_consensus_tpu_torch.bus.base import (
    EventCallback,
    EventPublisher,
    EventSubscriber,
    PoisonEnvelope,
    PublishError,
)

API_VERSION = "2017-04"
#: transient HTTP statuses worth retrying (the reference's
#: ``_is_transient_error`` heuristic, re-expressed for REST)
TRANSIENT_STATUSES = (408, 429, 500, 502, 503, 504)


def sas_token(endpoint: str, key_name: str, key: str,
              ttl_s: int = 3600, now: float | None = None) -> str:
    """Mint a SharedAccessSignature for the namespace URI (documented
    scheme: HMAC-SHA256 over ``<url-encoded-uri>\\n<expiry>``)."""
    uri = urllib.parse.quote_plus(endpoint.lower().rstrip("/"))
    expiry = int((now if now is not None else time.time()) + ttl_s)
    to_sign = f"{uri}\n{expiry}".encode()
    sig = base64.b64encode(
        hmac.new(key.encode(), to_sign, hashlib.sha256).digest())
    return ("SharedAccessSignature "
            f"sr={uri}&sig={urllib.parse.quote_plus(sig)}"
            f"&se={expiry}&skn={key_name}")


#: routing keys ride inside SqlFilter + ATOM XML (see
#: ``ensure_subscription``) — only this safe alphabet is accepted
_SAFE_RK = re.compile(r"[A-Za-z0-9._-]+\Z")


def validate_routing_key(rk: str) -> None:
    """Reject routing keys that cannot be safely interpolated into a
    SqlFilter expression / ATOM XML rule body. Called for EVERY key
    before any subscription state is mutated, so a bad key in a batch
    cannot leave partial routes behind."""
    if not _SAFE_RK.match(rk):
        raise ValueError(
            f"routing key {rk!r} contains characters outside "
            "[A-Za-z0-9._-]; refusing to build a SqlFilter from it")


def entity_name(rk: str, group: str) -> str:
    """Subscription name for (group, routing key): a readable sanitized
    prefix + a digest of the UNsanitized pair. The digest is what makes
    the name injective — sanitization collapses characters ('a-b'.'c'
    vs 'a'-'b.c' would collide on prefix alone) and a collision would
    silently drop the second key's messages behind the first key's SQL
    rule. Service Bus limits subscription names to 50 chars."""
    digest = hashlib.sha256(
        f"{group}\x00{rk}".encode()).hexdigest()[:8]
    raw = f"{group}-{rk}" if group else rk
    safe = re.sub(r"[^A-Za-z0-9._-]", "-", raw)[:41]
    return f"{safe}-{digest}"


class _Transport:
    """Shared REST plumbing: SAS header, retries, error mapping."""

    def __init__(self, namespace: str, key_name: str, key: str, *,
                 endpoint: str = "", timeout_s: float = 30.0,
                 retry_attempts: int = 3, retry_backoff_s: float = 0.3):
        if not namespace and not endpoint:
            raise ValueError("azure_servicebus needs namespace or endpoint")
        if not key:
            raise ValueError("azure_servicebus needs key")
        self.endpoint = (endpoint.rstrip("/") or
                         f"https://{namespace}.servicebus.windows.net")
        self.key_name = key_name or "RootManageSharedAccessKey"
        self.key = key
        self.timeout_s = timeout_s
        self.retry_attempts = retry_attempts
        self.retry_backoff_s = retry_backoff_s
        self._token = ""
        self._token_exp = 0.0
        self._token_lock = threading.Lock()

    def _auth(self) -> str:
        with self._token_lock:
            if time.time() > self._token_exp - 60:
                self._token = sas_token(self.endpoint, self.key_name,
                                        self.key)
                self._token_exp = time.time() + 3600
            return self._token

    def request(self, method: str, path: str, *,
                body: bytes | None = None,
                headers: dict[str, str] | None = None,
                ok: tuple[int, ...] = (200, 201),
                content_type: str = "application/json",
                retry: bool = True) -> tuple[int, bytes, dict[str, str]]:
        """One REST call with retry-on-transient; returns
        (status, body, lowercased headers). Statuses in ``ok`` return;
        everything else raises PublishError."""
        url = f"{self.endpoint}{path}"
        attempt = 0
        while True:
            req = urllib.request.Request(url, method=method, data=body,
                                         headers={
                                             "Authorization": self._auth(),
                                             "Content-Type": content_type,
                                             **(headers or {}),
                                         })
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    return (resp.status, resp.read(),
                            {k.lower(): v for k, v in resp.headers.items()})
            except urllib.error.HTTPError as exc:
                if exc.code in ok:
                    return (exc.code, exc.read(),
                            {k.lower(): v for k, v in exc.headers.items()})
                transient = exc.code in TRANSIENT_STATUSES
                if not (retry and transient
                        and attempt < self.retry_attempts):
                    detail = exc.read()[:200].decode("utf-8", "replace")
                    raise PublishError(
                        f"servicebus {method} {path} failed: "
                        f"HTTP {exc.code} {detail}") from exc
            except (urllib.error.URLError, TimeoutError, OSError) as exc:
                if not (retry and attempt < self.retry_attempts):
                    raise PublishError(
                        f"servicebus unreachable at {self.endpoint}: {exc}"
                    ) from exc
            time.sleep(self.retry_backoff_s * (2 ** attempt))
            attempt += 1

    # -- entity management (ATOM, idempotent: 409 Conflict == exists) --

    def ensure_topic(self, topic: str) -> None:
        atom = ('<entry xmlns="http://www.w3.org/2005/Atom">'
                '<content type="application/xml">'
                '<TopicDescription xmlns="http://schemas.microsoft.com/'
                'netservices/2010/10/servicebus/connect"/>'
                "</content></entry>")
        self.request("PUT", f"/{topic}", body=atom.encode(),
                     content_type="application/atom+xml",
                     ok=(201, 409))

    def ensure_subscription(self, topic: str, sub: str, rk: str, *,
                            lock_duration_s: int,
                            max_delivery_count: int) -> None:
        """Create subscription + replace the match-all $Default rule
        with the routing-key SQL filter (the reference's Bicep
        ``EventTypeFilter`` rule).

        ``rk`` is interpolated into both a SqlFilter expression and an
        ATOM XML body, so it is restricted to ``[A-Za-z0-9._-]``
        (``validate_routing_key``) — a quote or XML metacharacter would
        break or ALTER the subscription rule."""
        validate_routing_key(rk)
        atom = ('<entry xmlns="http://www.w3.org/2005/Atom">'
                '<content type="application/xml">'
                '<SubscriptionDescription xmlns="http://schemas.'
                'microsoft.com/netservices/2010/10/servicebus/connect">'
                f"<LockDuration>PT{lock_duration_s}S</LockDuration>"
                f"<MaxDeliveryCount>{max_delivery_count}"
                "</MaxDeliveryCount>"
                "<DeadLetteringOnMessageExpiration>true"
                "</DeadLetteringOnMessageExpiration>"
                "</SubscriptionDescription></content></entry>")
        self.request(
            "PUT", f"/{topic}/subscriptions/{sub}", body=atom.encode(),
            content_type="application/atom+xml", ok=(201, 409))
        # Rules are (re-)asserted even when the subscription already
        # existed (409): a crash between subscription-create and
        # rule-create would otherwise leave a permanent match-all
        # $Default rule feeding every routing key to this callback.
        # Both calls are idempotent (409/404 tolerated).
        rule = ('<entry xmlns="http://www.w3.org/2005/Atom">'
                '<content type="application/xml">'
                '<RuleDescription xmlns="http://schemas.microsoft.com/'
                'netservices/2010/10/servicebus/connect">'
                '<Filter i:type="SqlFilter" xmlns:i="http://www.w3.org/'
                '2001/XMLSchema-instance">'
                f"<SqlExpression>routing_key = '{rk}'</SqlExpression>"
                "</Filter></RuleDescription></content></entry>")
        self.request("PUT",
                     f"/{topic}/subscriptions/{sub}/rules/RoutingKeyFilter",
                     body=rule.encode(),
                     content_type="application/atom+xml", ok=(201, 409))
        self.request("DELETE",
                     f"/{topic}/subscriptions/{sub}/rules/%24Default",
                     ok=(200, 204, 404))


class AzureServiceBusPublisher(EventPublisher):
    """Topic publisher (reference
    ``azureservicebuspublisher.py:30`` role: persistent messages, retry
    with exponential backoff on transient errors, subject + custom
    properties for server-side filtering)."""

    def __init__(self, config: Any = None):
        cfg = dict(config or {})
        self.topic = cfg.get("topic") or cfg.get(
            "exchange", "copilot.events")
        self._t = _Transport(
            cfg.get("namespace", ""), cfg.get("key_name", ""),
            cfg.get("key", ""), endpoint=cfg.get("endpoint", ""),
            timeout_s=float(cfg.get("timeout_s", 30.0)),
            retry_attempts=int(cfg.get("retry_attempts", 3)),
            retry_backoff_s=float(cfg.get("retry_backoff_s", 0.3)))
        self._connected = False

    def connect(self) -> None:
        self._t.ensure_topic(self.topic)
        self._connected = True

    def publish_envelope(self, envelope, routing_key=None) -> None:
        if not self._connected:
            self.connect()
        if routing_key is None:
            from copilot_for_consensus_tpu_torch.core.events import EVENT_TYPES

            cls = EVENT_TYPES.get(envelope.get("event_type", ""))
            routing_key = cls.routing_key if cls else "unrouted"
        from copilot_for_consensus_tpu_torch.obs import trace

        # trace-context stamp, same contract as the broker/inproc
        # drivers: first publish injects, re-publish preserves
        envelope = trace.inject(envelope, routing_key)
        body = json.dumps(dict(envelope)).encode()
        # Label (subject) + custom property both carry the routing key:
        # rules filter on the property; operators read the subject.
        props = {"Label": routing_key,
                 "MessageId": str(envelope.get("event_id", "") or
                                  hashlib.sha256(body).hexdigest()[:32])}
        headers = {
            "BrokerProperties": json.dumps(props),
            # custom properties ride as headers with JSON-quoted values
            "routing_key": json.dumps(routing_key),
            "event_type": json.dumps(envelope.get("event_type", "")),
        }
        self._t.request("POST", f"/{self.topic}/messages", body=body,
                        headers=headers, ok=(201,))


class AzureServiceBusSubscriber(EventSubscriber):
    """Peek-lock consumer over topic subscriptions (reference
    ``azureservicebussubscriber.py:29`` role: manual complete/abandon,
    auto lock renewal, DLQ after MaxDeliveryCount)."""

    def __init__(self, config: Any = None, group: str | None = None):
        cfg = dict(config or {})
        self.topic = cfg.get("topic") or cfg.get(
            "exchange", "copilot.events")
        self.group = group or cfg.get("group") or ""
        self.lock_duration_s = int(cfg.get("lock_duration_s", 60))
        self.max_redeliveries = int(cfg.get("max_redeliveries", 3))
        self.peek_timeout_s = int(cfg.get("peek_timeout_s", 1))
        self.poll_interval_s = float(cfg.get("poll_interval_s", 0.05))
        self.auto_renew = bool(cfg.get("auto_renew", True))
        self._t = _Transport(
            cfg.get("namespace", ""), cfg.get("key_name", ""),
            cfg.get("key", ""), endpoint=cfg.get("endpoint", ""),
            timeout_s=float(cfg.get("timeout_s", 30.0)),
            retry_attempts=int(cfg.get("retry_attempts", 3)),
            retry_backoff_s=float(cfg.get("retry_backoff_s", 0.3)))
        self._routes: dict[str, EventCallback] = {}
        self._subs: dict[str, str] = {}      # rk -> subscription name
        self._stop = threading.Event()
        #: optional MetricsCollector, assigned by wiring code AFTER
        #: construction (services/runner.py) — deliberately NOT read
        #: from ``cfg``: the config mapping carries plain data, and a
        #: stray "metrics" key there must not masquerade as a collector
        self.metrics = None
        #: messages deleted by the $Default-window guard because their
        #: stamped key matched no local route (see _dispatch)
        self.misroute_dropped = 0

    # -- wiring ---------------------------------------------------------

    def subscribe(self, routing_keys, callback) -> None:
        # validate the whole batch BEFORE mutating routes: a bad key
        # mid-list must not leave earlier keys half-registered
        for rk in routing_keys:
            validate_routing_key(rk)
        self._t.ensure_topic(self.topic)
        for rk in routing_keys:
            self._routes[rk] = callback
            sub = entity_name(rk, self.group)
            self._t.ensure_subscription(
                self.topic, sub, rk,
                lock_duration_s=self.lock_duration_s,
                max_delivery_count=self.max_redeliveries + 1)
            self._subs[rk] = sub

    # -- peek-lock primitives ------------------------------------------

    def _receive(self, sub: str, timeout_s: int,
                 dlq: bool = False) -> dict | None:
        """One peek-lock receive. Returns ``{envelope?, raw, lock_path,
        props}`` or None when the subscription is empty."""
        path = (f"/{self.topic}/subscriptions/{sub}"
                f"{'/%24DeadLetterQueue' if dlq else ''}"
                f"/messages/head?timeout={timeout_s}")
        status, raw, headers = self._t.request("POST", path,
                                               ok=(201, 204))
        if status == 204:
            return None
        props = json.loads(headers.get("brokerproperties", "{}"))
        # the publisher stamps the routing key as a custom property,
        # which comes back as its own JSON-quoted header on receive
        stamped_rk = None
        if headers.get("routing_key"):
            try:
                stamped_rk = json.loads(headers["routing_key"])
            except ValueError:
                stamped_rk = headers["routing_key"]
        lock_path = urllib.parse.urlparse(
            headers.get("location", "")).path
        if not lock_path:       # per-spec fallback construction
            mid, token = props.get("MessageId"), props.get("LockToken")
            if not mid or not token:
                # can't settle a message we can't address; surface as
                # the loop's transient-error class, not a KeyError that
                # would kill the consumer thread
                raise PublishError(
                    "servicebus receive returned neither Location nor "
                    "BrokerProperties MessageId/LockToken")
            lock_path = (f"/{self.topic}/subscriptions/{sub}"
                         f"{'/%24DeadLetterQueue' if dlq else ''}"
                         f"/messages/"
                         f"{urllib.parse.quote(str(mid), safe='')}/"
                         f"{urllib.parse.quote(str(token), safe='')}")
        return {"raw": raw, "props": props, "lock_path": lock_path,
                "stamped_rk": stamped_rk}

    def _complete(self, msg: dict) -> bool:
        try:
            self._t.request("DELETE", msg["lock_path"], ok=(200,),
                            retry=False)
            return True
        except PublishError:
            # lock lost (expired / already settled): the broker will
            # redeliver — at-least-once holds, don't crash the loop
            return False

    def _abandon(self, msg: dict) -> None:
        try:
            self._t.request("PUT", msg["lock_path"], ok=(200,),
                            retry=False)
        except PublishError:
            pass                # lock expired == broker already requeued

    def _renew(self, msg: dict) -> bool:
        try:
            self._t.request("POST", msg["lock_path"], ok=(200,),
                            retry=False)
            return True
        except PublishError:
            return False

    # -- consume loop ---------------------------------------------------

    def _dispatch(self, rk: str, msg: dict) -> None:
        cb = self._routes.get(rk)
        try:
            envelope = json.loads(msg["raw"].decode("utf-8"))
            if not isinstance(envelope, dict):
                raise ValueError("envelope is not an object")
        except (ValueError, UnicodeDecodeError):
            # malformed body can never succeed: complete it so it does
            # not block the subscription (reference behavior for
            # JSONDecodeError, ``azureservicebussubscriber.py:568``)
            self._complete(msg)
            return
        if cb is None:
            self._complete(msg)
            return
        # The subscription's SQL rule is asserted idempotently, but a
        # message enqueued through the match-all $Default rule during
        # the create-subscription -> delete-$Default window carries
        # whatever routing key the publisher STAMPED (the same custom
        # property the SQL rule filters on). Route by the stamp, not
        # the subscription: when this consumer has a route for the
        # stamped key the message dispatches LOCALLY to that callback.
        # If the stamped key's own subscription already existed at
        # publish time it got its own copy and the handler runs twice —
        # an at-least-once duplicate the pipeline's idempotent-replay
        # design already absorbs; but if that subscription did NOT yet
        # exist (the same half-provisioned window, one key later in the
        # subscribe batch), this $Default copy is the ONLY delivery and
        # dropping it would LOSE the message. Loss is the failure mode
        # the guard must never convert a duplicate into. A stamped key
        # with no local route is completed (dropped) with a log line +
        # counter so the window leak is observable, never delivered to
        # the wrong callback. Unstamped messages (foreign publishers)
        # are not checkable and dispatch as before.
        stamped = msg.get("stamped_rk")
        if stamped is not None and stamped != rk:
            local = self._routes.get(stamped)
            if local is None:
                self.misroute_dropped += 1
                _LOG.warning(
                    "servicebus $Default-window guard dropped message: "
                    "stamped routing key %r arrived on subscription for "
                    "%r with no local route", stamped, rk)
                try:
                    if self.metrics is not None:
                        self.metrics.increment(
                            "bus_misroute_dropped",
                            labels={"stamped": stamped,
                                    "subscription": rk})
                except Exception:
                    pass   # metrics must never take the consumer down
                self._complete(msg)
                return
            rk, cb = stamped, local
        stop_renew = threading.Event()
        if self.auto_renew:
            interval = max(self.lock_duration_s / 2.0, 0.05)

            def renewer():
                while not stop_renew.wait(interval):
                    if not self._renew(msg):
                        return

            threading.Thread(target=renewer, daemon=True,
                             name="sb-lock-renewer").start()
        from copilot_for_consensus_tpu_torch.obs import trace

        try:
            # DeliveryCount starts at 1; attempt counts REdeliveries
            delivery = int(msg["props"].get("DeliveryCount", 1) or 1)
        except (TypeError, ValueError):
            delivery = 1
        trace.annotate_delivery(envelope, max(0, delivery - 1))
        try:
            cb(envelope)
        except PoisonEnvelope as exc:
            # Deterministic failure: the *Failed event (published by
            # BaseService before raising) is the operator record.
            # Settle the message — abandoning would re-run the handler
            # through the whole redelivery budget and mint a duplicate
            # failure event per delivery. This transport's REST surface
            # has no dead-letter settle op, so completing is the
            # degrade path bus/base.py names for drivers without
            # quarantine support.
            _LOG.warning("poison envelope settled on %r: %s",
                         rk, exc.reason)
            stop_renew.set()
            self._complete(msg)
            return
        except Exception:
            stop_renew.set()
            self._abandon(msg)   # redelivery; broker DLQs past max
            return
        stop_renew.set()
        self._complete(msg)

    def drain(self, max_messages: int | None = None) -> int:
        """Process what's queued now; returns the number handled."""
        n = 0
        progressed = True
        while progressed and (max_messages is None or n < max_messages):
            progressed = False
            for rk, sub in self._subs.items():
                if max_messages is not None and n >= max_messages:
                    break
                msg = self._receive(sub, 0)
                if msg is None:
                    continue
                self._dispatch(rk, msg)
                progressed = True
                n += 1
        return n

    def _long_poll_once(self) -> int:
        """One ``peek_timeout_s`` server-side long-poll round-robin over
        the subscriptions; dispatches at most one message per
        subscription. Against real Azure the server holds the request
        open, so an idle consumer costs one REST call per subscription
        per ``peek_timeout_s`` instead of one per ``poll_interval_s``."""
        n = 0
        for rk, sub in self._subs.items():
            if self._stop.is_set():
                break
            msg = self._receive(sub, self.peek_timeout_s)
            if msg is not None:
                self._dispatch(rk, msg)
                n += 1
        return n

    def start_consuming(self) -> None:
        """Blocking consume until stop(); drains fast while messages
        flow, falls back to server-side long-polling when idle, and
        survives outages by backing off (reference reconnect loop,
        ``azureservicebussubscriber.py:292``)."""
        self._stop.clear()
        backoff = self.poll_interval_s
        while not self._stop.is_set():
            try:
                n = self.drain()
                if n == 0:
                    n = self._long_poll_once()
            except PublishError:
                self._stop.wait(min(backoff, 5.0))
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = self.poll_interval_s
            if n == 0:
                # guards against servers that answer timeout>0 with an
                # immediate 204 (no server-side blocking)
                self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()

    # -- DLQ surface (failed-queues CLI parity) ------------------------

    def dead_letters(self, rk: str) -> list[dict]:
        """Drain-read the subscription's $DeadLetterQueue (peek-lock +
        complete, so inspection removes them like the broker CLI's
        ``purge`` after listing)."""
        sub = self._subs.get(rk) or entity_name(rk, self.group)
        out = []
        while True:
            msg = self._receive(sub, 0, dlq=True)
            if msg is None:
                return out
            try:
                out.append(json.loads(msg["raw"].decode("utf-8")))
            except ValueError:
                out.append({"_malformed": msg["raw"][:200].decode(
                    "utf-8", "replace")})
            self._complete(msg)
