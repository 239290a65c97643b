"""The port's roofline (``repro_torch/analysis/roofline.py``) and
comparison (``analysis/perf_compare.py``) on the CPU.

* ``analyze`` on the JAX package's synthetic dry-run record
  (``tests/test_dryrun.py::test_roofline_analysis_on_record``), with the
  port's constants patched to the TPU's, equals JAX's row field by field.
* Each kernel's ``cost`` with ``kernel_bound`` / ``tc_bound`` reproduces
  the bound column of PERF.md's kernel table (the H100's peaks), to the
  four places it is written.
* Artifact mode: a regressed median, a vanished self-check and a new row
  in two hand-written artifacts; roofline mode over two record
  directories.
"""

import json

import pytest
import torch

from repro.analysis import roofline as jroofline
from repro_torch.analysis import perf_compare, roofline
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba2_ssd import ops as ssd
from repro_torch.kernels.rwkv6_wkv import ops as wkv

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread (the suite's parallel
    workers each start torch)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RECORD = {
    "status": "ok", "arch": "yi-9b", "shape": "decode_32k",
    "mesh": "pod16x16", "step": "serve_step", "n_devices": 256,
    "cost": {"flops": 1e9, "bytes_accessed": 1e9},
    "collectives": {"total_bytes": 1e6},
    "memory": {"argument_bytes": 2 * 2 ** 30, "temp_bytes": 2 ** 30,
               "output_bytes": 2 ** 30, "alias_bytes": 2 ** 30},
}


def test_analyze_equals_jax_with_the_tpu_constants(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroofline.ICI_BW)
    monkeypatch.setattr(roofline, "HBM_BYTES", 16 * 1024 ** 3)
    got, want = roofline.analyze(RECORD), jroofline.analyze(RECORD)
    assert got.as_dict() == want.as_dict()
    assert got.bound_time_s == want.bound_time_s
    assert roofline.model_flops("yi-9b", "train_4k") == \
        jroofline.model_flops("yi-9b", "train_4k")


def test_one_card_has_no_link_term():
    rec = dict(RECORD, mesh="gpu1", n_devices=1,
               collectives={"total_bytes": 0})
    row = roofline.analyze(rec)
    assert row.collective_s == 0.0 and row.dominant == "memory"
    assert row.fits_hbm is True and row.bytes_per_chip == 3 * 2 ** 30
    assert "shared memory" in roofline.what_would_help(row)
    with pytest.raises(ValueError, match="no link"):
        roofline.analyze(RECORD)
    assert roofline.analyze(dict(RECORD, status="skipped")) is None
    # a dry-run of a shape outside the table carries its own
    custom = dict(rec, shape="engine_tick",
                  input_shape={"seq_len": 1024, "global_batch": 8,
                               "kind": "decode"})
    assert roofline.analyze(custom).model_flops_per_chip == \
        roofline.model_flops("yi-9b", "decode_32k") * 8 / 128


# the bound column of PERF.md's kernel table: (what, cost, peak, ms)
BOUNDS = [
    ("K1 yi-9b", fa.flash_attention_cost(8, 256, 256, 32, 4, 128, 2),
     "bfloat16", 0.0113),
    ("K1 backward danube", fa.flash_attention_bwd_cost(
        4, 2048, 2048, 32, 8, 80, 2, window=4096), "bfloat16", 0.2172),
    # the ticks' valid keys (and K3's pages) are those of chip_smoke.py's
    # tick cases, whose ragged lengths are drawn on the card: its log
    # prints them ("valid keys 4486", "valid keys 1261", 2713932 bytes)
    ("K2 tick", da.decode_attention_cost(8, 32, 4, 128, 1024, 2, 2, 4486),
     "bfloat16", 0.0028),
    ("K2 32k", da.decode_attention_cost(8, 32, 4, 128, 32768, 2, 2),
     "bfloat16", 0.1603),
    ("K3 tick", da.paged_decode_attention_cost(8, 32, 4, 128, 64, 16, 2, 2,
                                               1261, 83), "bfloat16", 0.0008),
    ("K4 bucket", wkv.wkv6_cost(8, 512, 32, 64), "float32", 0.0526),
    ("K4 backward", wkv.wkv6_bwd_cost(4, 2048, 32, 64), "float32", 0.2310),
    ("K5 bucket", ssd.ssd_cost(8, 512, 80, 64, 64), "float32", 0.0930),
    ("K5 backward", ssd.ssd_bwd_cost(4, 2048, 80, 64, 64), "float32",
     0.5846),
]
TC_BOUNDS = [("K4 backward", wkv.wkv6_bwd_cost(4, 2048, 32, 64), 0.1815),
             ("K5 bucket", ssd.ssd_cost(8, 512, 80, 64, 64), 0.0574),
             ("K5 backward", ssd.ssd_bwd_cost(4, 2048, 80, 64, 64), 0.2974)]


@pytest.mark.parametrize("what,cost,dtype,ms", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_kernel_bounds_reproduce_the_table(what, cost, dtype, ms):
    bound, _ = roofline.kernel_bound(cost.nbytes, cost.flops, dtype)
    assert round(bound, 4) == ms, what


@pytest.mark.parametrize("what,cost,ms", TC_BOUNDS,
                         ids=[b[0] for b in TC_BOUNDS])
def test_tensor_core_bounds_reproduce_the_table(what, cost, ms):
    bound, _ = roofline.tc_bound(cost.nbytes, cost.products, cost.other)
    assert round(bound, 4) == ms, what


def test_tick_bytes_equal_the_chip_log():
    assert da.decode_attention_cost(8, 32, 4, 128, 1024, 2, 2,
                                    4486).nbytes == 9318400
    assert da.paged_decode_attention_cost(8, 32, 4, 128, 64, 16, 2, 2, 1261,
                                          83).nbytes == 2713932


def test_k1_bytes_and_bound_kind():
    c = fa.flash_attention_cost(8, 256, 256, 32, 4, 128, 2)
    assert round(c.nbytes / 1e6, 1) == 37.7
    assert roofline.kernel_bound(c.nbytes, c.flops, "bfloat16")[1] == "bytes"
    c = fa.flash_attention_cost(8, 1024, 1024, 32, 4, 128, 2)
    assert roofline.kernel_bound(c.nbytes, c.flops, "bfloat16") == (
        pytest.approx(0.0696, abs=5e-5), "operations")


def _artifact(commit, medians, checks):
    return {"scenario": "decode", "commit": commit,
            "medians": [{"name": n, "us_per_call": v} for n, v in medians],
            "self_checks": [{"name": n, "passed": p} for n, p in checks]}


def test_artifact_mode(tmp_path, capsys):
    base = _artifact("a" * 40, [("tick", 100.0), ("prefill", 50.0)],
                     [("ids_only", True), ("bitwise", True)])
    cand = _artifact("b" * 40, [("tick", 125.0), ("prefill", 50.0),
                                ("paged_tick", 80.0)],
                     [("ids_only", True)])
    report, regressions = perf_compare.compare_artifacts(base, cand)
    assert len(regressions) == 2
    assert "'tick'" in regressions[0] and "+25.0%" in regressions[0]
    assert "'bitwise': pass -> missing" in regressions[1]
    assert "new" in report and "paged_tick" in report
    paths = []
    for name, doc in (("A", base), ("B", cand), ("C", base)):
        paths.append(tmp_path / f"BENCH_{name}.json")
        paths[-1].write_text(json.dumps(doc))
    assert perf_compare.main([str(paths[0]), str(paths[1])]) == 1
    assert perf_compare.main([str(paths[0]), str(paths[2])]) == 0
    assert "no regressions" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit):
        perf_compare.main([str(paths[0]), str(bad)])


def test_roofline_mode_and_table(tmp_path, capsys):
    rec = dict(RECORD, mesh="gpu1", n_devices=1,
               collectives={"total_bytes": 0})
    for d, flops in (("base", 2e9), ("opt", 1e9)):
        (tmp_path / d).mkdir()
        (tmp_path / d / "yi-9b.decode_32k.gpu1.json").write_text(
            json.dumps(dict(rec, cost={"flops": flops,
                                       "bytes_accessed": 1e9})))
        (tmp_path / d / "whisper-base.long_500k.gpu1.json").write_text(
            json.dumps({"arch": "whisper-base", "shape": "long_500k",
                        "mesh": "gpu1", "status": "skipped"}))
    text = perf_compare.compare(str(tmp_path / "base"), str(tmp_path / "opt"))
    assert "yi-9b x decode_32k" in text and "2.00x" in text
    assert "fits Y" in text
    assert roofline.main(["--dir", str(tmp_path / "base")]) == 0
    out = capsys.readouterr().out
    assert "yi-9b" in out and "whisper" not in out
