"""Port parity: the bench entry (``engine/bench.py``, ``cli bench``) of
blazr_tpu_torch against blazr_tpu on the CPU: the same result dict and
keys, the same profiles and sweep, the CLI's ``--json`` and ``--profile``
outputs, and a GGUF file benchmarked through its embedded tokenizer."""

import dataclasses
import json

import pytest

from blazr_tpu.engine import bench as jbench
from blazr_tpu_torch.cli.main import main as cli_main
from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
from blazr_tpu_torch.engine import bench as tbench
from blazr_tpu_torch.utils.synthetic import write_gguf_checkpoint

CPU = "cpu"


def _keys(result: dict):
    return (sorted(result), {k: sorted(v) for k, v in result["profiles"].items()})


def test_profiles_and_metrics_match_jax():
    assert tbench.WORKLOAD_PROFILES == jbench.WORKLOAD_PROFILES
    assert tbench.CONCURRENCY_SWEEP == jbench.CONCURRENCY_SWEEP
    assert [f.name for f in dataclasses.fields(tbench.BenchMetrics)] == [
        f.name for f in dataclasses.fields(jbench.BenchMetrics)]


def test_synthetic_run_returns_the_jax_keys():
    kw = dict(prompt_lens=[4, 9], decode_tokens=3, runs=1)
    got = tbench.run_benchmark(device=CPU, **kw)
    ref = jbench.run_benchmark(**kw)
    assert _keys(got) == _keys(ref)
    assert (got["model"], got["platform"], got["decode_tokens"]) == (
        ref["model"], ref["platform"], ref["decode_tokens"]) == ("synthetic-tiny", "cpu", 3)
    for plen in ("4", "9"):
        m = got["profiles"][plen]
        assert m["prompt_tokens"] == int(plen) and m["runs"] == 1
        assert m["ttft_ms"] > 0 and m["decode_tok_s"] > 0
        assert m["itl_p50_ms"] <= m["itl_p95_ms"] <= m["itl_p99_ms"]


def test_bench_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.run_benchmark(prompt_lens=[4], decode_tokens=2, runs=1)


def test_cli_bench_gguf_json_and_profile(tmp_path, capsys):
    cfg = UniversalConfig(model_type="llama", vocab_size=320, hidden_size=256,
                          num_layers=1, max_seq_len=256, intermediate_size=512,
                          attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                    head_dim=64))
    f = tmp_path / "m.gguf"
    write_gguf_checkpoint(f, cfg, "Q4_K_M")
    out, prof = tmp_path / "r.json", tmp_path / "prof"
    rc = cli_main(["--device", "cpu", "bench", str(f), "--prompt-lens", "5,12",
                   "--decode-tokens", "2", "--runs", "1", "--json", str(out),
                   "--profile", str(prof)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    written = json.loads(out.read_text())
    assert printed == written
    assert written["model"] == str(f) and written["platform"] == "cpu"
    assert sorted(written["profiles"]) == ["12", "5"]
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
