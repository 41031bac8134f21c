"""HMAC-signed incident webhook delivery with retry/backoff.

Reference: ``pkg/webhook/exporter.go:63-140`` — exponential backoff over
3 attempts, 4xx non-retryable, ``X-Webhook-Signature: sha256=<hex>``.

The port's own copy of ``tpuslo/webhook/exporter.py``.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import http.client
import json
import random
import time
import urllib.error
import urllib.request
from typing import Callable

from tpuslo_torch.delivery import full_jitter_delay
from tpuslo_torch.schema import IncidentAttribution
from tpuslo_torch.webhook.opsgenie import build_opsgenie_payload
from tpuslo_torch.webhook.pagerduty import build_pagerduty_payload

FORMAT_GENERIC = "generic"
FORMAT_PAGERDUTY = "pagerduty"
FORMAT_OPSGENIE = "opsgenie"

USER_AGENT = "tpuslo/webhook"


class WebhookError(RuntimeError):
    def __init__(self, message: str, retryable: bool = True):
        super().__init__(message)
        self.retryable = retryable


def compute_hmac(payload: bytes, secret: str) -> str:
    mac = hmac_mod.new(secret.encode(), payload, hashlib.sha256)
    return "sha256=" + mac.hexdigest()


def verify_hmac(payload: bytes, secret: str, signature: str) -> bool:
    return hmac_mod.compare_digest(compute_hmac(payload, secret), signature)


class Exporter:
    """Delivers incident attributions to an HTTP webhook endpoint."""

    def __init__(
        self,
        url: str,
        secret: str = "",
        format: str = FORMAT_GENERIC,
        timeout_ms: int = 5000,
        max_retry: int = 3,
        base_delay_s: float = 1.0,
        max_delay_s: float = 8.0,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
    ):
        self.url = url
        self.secret = secret
        self.format = format or FORMAT_GENERIC
        self.timeout_s = (timeout_ms if timeout_ms > 0 else 5000) / 1000.0
        self.max_retry = max_retry
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self._sleep = sleep
        self._rng = rng

    def build_payload(self, attr: IncidentAttribution) -> bytes:
        if self.format == FORMAT_PAGERDUTY:
            return build_pagerduty_payload(attr)
        if self.format == FORMAT_OPSGENIE:
            return build_opsgenie_payload(attr)
        return json.dumps(attr.to_dict()).encode()

    def send(self, attr: IncidentAttribution) -> None:
        """Deliver one attribution; raises WebhookError on final failure."""
        payload = self.build_payload(attr)
        last_error: WebhookError | None = None
        for attempt in range(self.max_retry):
            if attempt > 0:
                # Full jitter with a hard cap: a hung endpoint already
                # consumed timeout_s per attempt, so unjittered 1-2-4s
                # sleeps both synchronize retry storms across agents and
                # stack unbounded delay onto the caller.
                self._sleep(
                    full_jitter_delay(
                        attempt - 1, self.base_delay_s, self.max_delay_s,
                        self._rng,
                    )
                )
            try:
                self._post(payload)
                return
            except WebhookError as exc:
                last_error = exc
                if not exc.retryable:
                    raise
        raise WebhookError(
            f"webhook delivery failed after {self.max_retry} attempts: {last_error}"
        )

    def post_payload(self, payload: bytes) -> None:
        """Single-shot signed POST, no retries — the delivery channel
        owns backoff/spooling when the webhook routes through it."""
        self._post(payload)

    def _post(self, payload: bytes) -> None:
        headers = {
            "Content-Type": "application/json",
            "User-Agent": USER_AGENT,
        }
        if self.secret:
            headers["X-Webhook-Signature"] = compute_hmac(payload, self.secret)
        req = urllib.request.Request(
            self.url, data=payload, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                resp.read()
                status = resp.status
        except urllib.error.HTTPError as exc:
            status = exc.code
        except TimeoutError as exc:
            # A hang consumes the full timeout budget; it is explicitly
            # retryable (the endpoint may just be overloaded).
            raise WebhookError(
                f"timed out after {self.timeout_s:.1f}s", retryable=True
            ) from exc
        except urllib.error.URLError as exc:
            if isinstance(exc.reason, TimeoutError):
                raise WebhookError(
                    f"timed out after {self.timeout_s:.1f}s", retryable=True
                ) from exc
            raise WebhookError(f"http post failed: {exc.reason}") from exc
        except (http.client.HTTPException, OSError) as exc:
            # Dropped mid-exchange (BadStatusLine / RemoteDisconnected):
            # an endpoint outage, retryable like any 5xx.
            raise WebhookError(f"http post failed: {exc!r}") from exc
        if status >= 500:
            raise WebhookError(f"server error: HTTP {status}")
        if status in (408, 429):
            # Rate limiting / request timeout: retryable by definition.
            raise WebhookError(f"throttled: HTTP {status}", retryable=True)
        if status >= 400:
            raise WebhookError(f"client error: HTTP {status}", retryable=False)
