"""The port's stdlib client (``repro_torch/serving/client.py``) against the
JAX package's copy, on the inputs of tests/test_client_retry.py:
``Retry-After`` parsing, the typed error taxonomy, retry decisions,
backoff delays (same jitter draws) and hedge delays must be equal."""

import email.utils
import json
import random
import time

import pytest

from repro.serving import client as jclient
from repro_torch.serving import client as tclient

RETRY_AFTER = [b"0", b"1", b"2.5", b" 7 ", b"", b"   ", b"nan", b"NaN",
               b"inf", b"-inf", b"soon", b"1s", b"\xff\xfe garbage", b"-3"]


@pytest.mark.parametrize("raw", RETRY_AFTER)
def test_parse_retry_after_equal(raw):
    assert tclient.parse_retry_after(raw) == jclient.parse_retry_after(raw)


@pytest.mark.parametrize("offset", [30, -60])
def test_parse_http_dates_equal(offset):
    raw = email.utils.formatdate(time.time() + offset, usegmt=True).encode()
    got, want = tclient.parse_retry_after(raw), jclient.parse_retry_after(raw)
    assert got == pytest.approx(want, abs=1.0)
    naive = time.strftime("%a, %d %b %Y %H:%M:%S",
                          time.gmtime(time.time() + 20)).encode()
    assert tclient.parse_retry_after(naive) == pytest.approx(
        jclient.parse_retry_after(naive), abs=1.0)


def _body(code, message="boom", retryable=False, trace_id="t-1"):
    return json.dumps({"error": {"code": code, "message": message,
                                 "retryable": retryable,
                                 "trace_id": trace_id}}).encode()


ERRORS = [(400, _body("bad_request"), None, None),
          (404, _body("not_found"), None, None),
          (409, _body("conflict"), None, None),
          (429, _body("queue_full", retryable=True), 0.25, None),
          (503, _body("unavailable", retryable=True), None, None),
          (504, _body("deadline_exceeded"), None, None),
          (408, _body("timeout", retryable=True), None, None),
          (501, _body("not_ported"), None, None),
          (418, _body("teapot"), None, None),
          (429, b'{"error": "queue full"}', 1.5, "hdr-id"),
          (500, b"not json at all", None, None),
          (503, _body("unavailable", retryable=False), None, None),
          (429, b"", None, None), (500, b"", None, None)]


@pytest.mark.parametrize("status,raw,retry_after,trace_id", ERRORS)
def test_make_error_and_retry_decision_equal(status, raw, retry_after,
                                             trace_id):
    got = tclient.make_error(status, raw, retry_after, trace_id, "POST /x")
    want = jclient.make_error(status, raw, retry_after, trace_id, "POST /x")
    assert type(got).__name__ == type(want).__name__
    for attr in ("status", "retry_after_s", "code", "retryable",
                 "trace_id", "structured"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert str(got) == str(want)
    assert (tclient.FlexServeClient()._should_retry(got)
            == jclient.FlexServeClient()._should_retry(want))


@pytest.mark.parametrize("hint", [None, float("nan"), -1.0, 0.5, 100.0])
def test_backoff_delays_equal(hint):
    ours = tclient.FlexServeClient(backoff_s=0.05, max_backoff_s=2.0)
    theirs = jclient.FlexServeClient(backoff_s=0.05, max_backoff_s=2.0)
    for attempt in (1, 2, 3, 8):
        random.seed(attempt)
        got = ours._backoff_delay(attempt, hint)
        random.seed(attempt)
        assert got == theirs._backoff_delay(attempt, hint)
        assert 0.0 < got <= 2.0


@pytest.mark.parametrize("hedge_ms", [None, 20, "p95"])
def test_hedge_delays_equal(hedge_ms):
    ours = tclient.FlexServeClient(hedge_ms=hedge_ms)
    theirs = jclient.FlexServeClient(hedge_ms=hedge_ms)
    assert ours._hedge_delay_s("/v1/infer") == theirs._hedge_delay_s(
        "/v1/infer")
    for ms in (10,) * 19 + (1000,):
        ours._record_latency("/v1/infer", ms / 1e3)
        theirs._record_latency("/v1/infer", ms / 1e3)
    assert ours._hedge_delay_s("/v1/infer") == theirs._hedge_delay_s(
        "/v1/infer")
    with pytest.raises(ValueError):
        tclient.FlexServeClient(hedge_ms="always")


def test_typed_errors_and_request_bodies_equal():
    assert set(tclient.ERROR_TYPES) == set(jclient.ERROR_TYPES)
    for code, cls in tclient.ERROR_TYPES.items():
        assert cls.__name__ == jclient.ERROR_TYPES[code].__name__
    kw = dict(temperature=0.8, top_k=50, seed=3, stop=[7], client_tag="a")
    assert (tclient.FlexServeClient._generate_body([[1, 2]], 5, None, **kw)
            == jclient.FlexServeClient._generate_body([[1, 2]], 5, None,
                                                      **kw))
    ours, theirs = tclient.FlexServeClient(), jclient.FlexServeClient()
    assert (ours._raw_request("POST", "/v1/generate", {"prompts": [[1]]})
            == theirs._raw_request("POST", "/v1/generate",
                                   {"prompts": [[1]]}))
