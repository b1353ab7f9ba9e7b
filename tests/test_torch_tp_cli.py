"""`llmctl-torch serve start --tensor-parallel 2` on the CPU.

The command is rank 0 and the server; it starts rank 1 as its child
through ``runtime.launcher.LocalLauncher`` (the same command line,
``RANK`` set), which follows rank 0's descriptors. The served greedy
tokens equal the port's one-rank engine on the same weights (gpt-test
from seed 0, fp32); /health answers; SIGTERM stops both ranks, exit 0;
each rank prints its ``LLMCTL_SERVE_LAUNCHES`` report with equal
forward passes and sampled-token digests.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)

ROOT = Path(__file__).resolve().parents[1]
CLI = "distributed_llm_training_and_inference_system_tpu_torch.cli"
PROMPTS = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_start_tensor_parallel_2_serves_one_engines_tokens():
    cfg = get_model_config("gpt-test")
    one = InferenceEngine(cfg, ServeConfig(
        model="gpt-test", max_seq_len=128, dtype="float32",
        kv_hbm_budget_gb=0.01), device="cpu")
    want = [r.generated_tokens for r in one.generate(
        PROMPTS, SamplingParams(temperature=0.0, max_tokens=6))]
    cmd = [sys.executable, "-m", CLI, "--device", "cpu", "serve", "start",
           "--model", "gpt-test", "--host", "127.0.0.1", "--port", "0",
           "--tensor-parallel", "2", "--kv-hbm-gb", "0.01", "--max-seq-len",
           "128"]
    # one intra-op thread a rank: gpt-test is tiny, and parallel test
    # workers share the cores
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        lines, port = [], None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, f"the server exited: {lines}"
            lines.append(line)
            m = re.search(r"serving gpt-test on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert "backend gloo" in "".join(lines)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            assert json.loads(r.read())["status"] == "healthy"
        got = [_post(port, {"prompt": p, "max_tokens": 6,
                            "temperature": 0.0})["choices"][0]["token_ids"]
               for p in PROMPTS]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert got == want
    reports = sorted((json.loads(line.split(" ", 1)[1])
                      for line in err.splitlines()
                      if line.startswith("LLMCTL_SERVE_LAUNCHES ")),
                     key=lambda r: r["rank"])
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["paged_passes"] == reports[1]["paged_passes"] > 0
    assert reports[0]["token_digest"] == reports[1]["token_digest"]
    # the CPU runs no kernel: every wrapper took its plain version
    assert all(r["paged_attention"] == 0 for r in reports)
