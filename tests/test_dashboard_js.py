"""Execute the dashboard's inline JS (frontend.py:58-105) for real.

The reference's UI loop (submit -> poll -> charts,
``event-driven/frontend/app.py:226-274``) is covered at the HTTP level by
tests/test_serve_dispatch.py, but the inline script — the 2 s poll loop,
the SVG chart math, and the ``esc()`` HTML-escaping — only runs in a
browser. This module runs THAT EXACT SCRIPT (extracted from the page the
live frontend serves, not a copy) under a JS runtime with a minimal DOM
shim: ``document.getElementById``, a tracked ``innerHTML``, and ``fetch``
rewritten to the live in-process stack.

Runtime discovery: ``node`` (>=18, native fetch) or ``bun``. The CI
image ships NO JavaScript engine at all (node, bun, chromium, dukpy,
js2py all absent and installs are pinned), so here these tests SKIP with
that reason; on any normal dev machine or CI with node they execute the
shipped script end-to-end. The DOM-shim harness was chosen over a
headless browser dependency precisely so the only requirement is a JS
runtime binary on PATH.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest

JS_RUNTIME = shutil.which("node") or shutil.which("bun")

needs_js = pytest.mark.skipif(
    JS_RUNTIME is None,
    reason="no JS runtime in this image (node/bun absent, installs "
           "pinned) — runs on any host with node >= 18 on PATH")

# DOM/fetch shim prepended to the extracted page script. The page script
# ends by calling poll(); the watchdog prints the rendered innerHTML as
# JSON once it stops changing from empty, then exits.
_SHIM = r"""
const __base = process.env.DASH_BASE;
globalThis.window = globalThis;
const __els = { result: { innerHTML: "" } };
globalThis.document = { getElementById: (id) => __els[id] };
const __fetch = globalThis.fetch;
globalThis.fetch = (url, opts) => __fetch(__base + url, opts);
let __ticks = 0;
const __watch = setInterval(() => {
  __ticks += 1;
  if (__els.result.innerHTML !== "" || __ticks > 300) {
    clearInterval(__watch);
    console.log(JSON.stringify({ html: __els.result.innerHTML }));
    process.exit(0);
  }
}, 100);
"""


def _page_script(html: str) -> str:
    """The inline <script> exactly as served (key binding included)."""
    m = re.search(r"<script>(.*?)</script>", html, re.S)
    assert m, "dashboard page has no inline script"
    return m.group(1)


def _run_js(script: str, base_url: str, timeout: float = 60.0) -> dict:
    import os

    out = subprocess.run(
        [JS_RUNTIME, "-e", _SHIM + script],
        env={**os.environ, "DASH_BASE": base_url},
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture()
def stack(tmp_path):
    """Live in-process frontend + worker over a filesystem root."""
    from openmp_parallel_computing_tpu.dispatch.frontend import (
        serve as serve_frontend)
    from openmp_parallel_computing_tpu.dispatch.worker import Worker
    from openmp_parallel_computing_tpu.utils.config import DispatchConfig

    cfg = DispatchConfig(root=str(tmp_path / "d"))
    httpd, state = serve_frontend(cfg, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield (f"http://127.0.0.1:{httpd.server_address[1]}",
               Worker(cfg), state)
    finally:
        httpd.shutdown()
        state.shutdown()


def _png_bytes(tmp_path) -> bytes:
    from openmp_parallel_computing_tpu import imgio

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (24, 136, 3), dtype=np.uint8)
    p = tmp_path / "f.png"
    imgio.save_png(p, img)
    return p.read_bytes()


def test_harness_preconditions(stack, tmp_path):
    """Runs EVERYWHERE (no JS needed): pins the contract the JS harness
    depends on — the page's inline script + key binding + result div,
    and the /status payload fields the script consumes — so the
    skip-gated tests cannot rot unnoticed in the JS-less dev image."""
    import requests

    base, worker, _ = stack
    hostile = 'x<img src=q onerror=window.__pwned=1>.png'
    resp = requests.post(base + "/", files={
        "image": (hostile, _png_bytes(tmp_path), "image/png")},
        data={"kernel": "grayscale", "threads": "1,2",
              "repeat": "1", "passes": "1"})
    assert resp.status_code == 200
    script = _page_script(resp.text)
    assert "const key =" in script and "poll()" in script
    assert 'id="result"' in resp.text
    # the served key binding is script-safe even for markup-bearing keys
    m = re.search(r"const key = (.*?);", script)
    assert "</script" not in m.group(1)
    key = json.loads(m.group(1))
    assert key.startswith("uploads/") and hostile in key
    worker.run(stop_when_empty=True)
    st = requests.get(base + "/status",
                      params={"key": key}).json()
    assert st["processed"] and "times" in st and "processed_key" in st
    assert set(st["times"]) == {"1", "2"}


@needs_js
def test_submit_poll_charts_render(stack, tmp_path):
    """Full UI loop: POST the form (hostile filename included), process
    the job, run the served page's own script against the live /status —
    assert the SVG time + speed-up charts rendered with one bar per
    device count and the result link is URI-encoded, not injected."""
    import requests

    base, worker, _ = stack
    hostile = 'x<img src=q onerror=window.__pwned=1>.png'
    resp = requests.post(base + "/", files={
        "image": (hostile, _png_bytes(tmp_path), "image/png")},
        data={"kernel": "grayscale", "threads": "1,2",
              "repeat": "1", "passes": "1"})
    assert resp.status_code == 200
    worker.run(stop_when_empty=True)          # process the queued job

    out = _run_js(_page_script(resp.text), base)
    html = out["html"]
    assert html.count("<svg") == 2            # time + speed-up charts
    assert html.count("<rect") == 4           # 2 device counts x 2 charts
    assert "1dev" in html and "2dev" in html
    # hostile filename rides the result href only URI-encoded — the raw
    # tag never appears in the document
    assert "<img" not in html
    assert "%3Cimg" in html


@needs_js
def test_error_branch_escapes_hostile_text(stack, tmp_path):
    """The esc() path: a completion whose error string carries markup
    must render inert (the script's own escaping, executed for real)."""
    import requests

    base, _, state = stack
    key = "uploads/deadbeef_x.png"
    # Inject a hostile error completion the way the worker publishes one.
    state.processed[key] = {
        "image_key": key,
        "error": '<img src=q onerror=window.__pwned=1> & "quotes"',
    }
    page = requests.get(base + "/?key=" + key).text
    out = _run_js(_page_script(page), base)
    html = out["html"]
    assert "job failed" in html
    assert "<img" not in html                  # no raw tag anywhere
    assert "&lt;img" in html and "&amp;" in html and "&quot;" in html
