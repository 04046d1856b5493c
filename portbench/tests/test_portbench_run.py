"""A run end to end: the result line, the trace's reading, the control in
bfloat16 and faults planted in the program all read as the contract says.

Everything here runs the port's CPU paths except ``test_cli_on_the_card``,
which needs a CUDA device and skips without one (decided in its fixture).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import portbench.run as R
from portbench import harness
from portbench.kinds import records, stream
from portbench.tests.test_portbench_reference import (PACKETS_MIX,
                                                      RECORDS_CFG,
                                                      RECORDS_MIX,
                                                      STREAM_CFG)

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"records": (RECORDS_CFG, RECORDS_MIX),
         "stream": (STREAM_CFG, PACKETS_MIX)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small(kind: str, seconds=0.3, trace=0) -> dict:
    cfg, mix = SMALL[kind]
    return R.measure(BENCH, CELLS[0], cfg, mix, 41, seconds, trace, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_of_each_cell(cell):
    args = R.parse_args(["--workload", cell, "--seed", str(2**31 + 5),
                         "--seconds", "4", "--trace", "0"])
    res = R.run(args, "cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    wanted = {m["name"] for m in BENCH["end_to_end"] if R.applies(m, cell)}
    assert set(res["metrics"]) == wanted
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("kind", ["records", "stream"])
def test_traced_run_reads_its_per_layer_metrics(kind):
    res = small(kind, trace=1)
    assert res["correct"] is True
    # no device here: the trace's readers find nothing, the rest read
    assert {"request_host_ms", "backend_row_share",
            "step_mfu"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


def test_trace_reading():
    ev = [{"ph": "X", "cat": "kernel", "name": "void k1<1>(int)",
           "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "void k2(float*)",
           "ts": 5.0, "dur": 10.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
           "Pinned)", "ts": 40.0, "dur": 5.0},
          {"ph": "X", "cat": "kernel", "ts": 50.0, "dur": 1.0,
           "name": "void (anonymous namespace)::k3<(int)2>(float*, int)"},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.wait",
           "ts": 12.0, "dur": 30.0}]
    out = harness.read_trace(ev, 1e-4)
    assert out["busy_s"] == pytest.approx(21e-6)
    assert out["idle_gaps"] == [["portbench.wait", pytest.approx(25e-6)],
                                ["portbench.other", pytest.approx(5e-6)]]
    assert [n for n, _ in out["device_ops"]] == [
        "k1<1>", "k2", "Memcpy DtoH", "anon::k3<(int)2>"]
    r = harness.Readings(call_s=[], counters={}, trace=dict(out, requests=2),
                         bounds={"b1": (4e-6, 2)})
    assert harness.kernel_share(r, "b1", "k1") == pytest.approx(20.0)
    assert harness.kernel_share(r, "b5", "k2") is None


# -- the control: the reference in bfloat16 in the program's place --------

def test_control_fails_the_records_comparison():
    cell = records.Cell.offline(RECORDS_CFG, RECORDS_MIX, 43, "cpu")
    numbers = cell.control(6)
    assert any(v > lim for v, lim in numbers.values())


def test_control_fails_the_stream_comparison():
    cell = stream.Cell.offline(STREAM_CFG, PACKETS_MIX, 44, "cpu")
    numbers = cell.control(24)
    assert all(v > lim for v, lim in numbers.values())


def test_control_cli_needs_the_request_count():
    from portbench import control
    with pytest.raises(SystemExit):
        control.main(["--workload", CELLS[0], "--seeds", "1"])


# -- the serving scaffold ---------------------------------------------------

def test_serving_keeps_no_python_object_a_request():
    """The logs hold each request's answers and telemetry in blocks, so the
    window adds nothing to the host's collector but what the program
    itself keeps."""
    import gc
    cfg, mix = SMALL["records"]
    cell = records.Cell(cfg, mix, 45, "cpu")
    harness.run_count(cell, 0, 20, cell.depth)
    gc.collect()
    before = len(gc.get_objects())
    harness.run_count(cell, 20, 200, cell.depth)
    gc.collect()
    assert len(gc.get_objects()) - before < 50
    assert len(cell.preds) == 220 and cell.stat_log.n == 220


def test_logs_keep_each_request_in_order():
    log = harness.HostLog(3)
    far = harness.LOG_BLOCK + 2
    for j in (0, 1, far):
        log.put(j, torch.tensor([j % 2, -1, 1]).numpy())
    assert len(log) == far + 1 and len(log.blocks) == 2
    assert log[1].tolist() == [1, -1, 1] and log[1].dtype.name == "int8"
    assert log[far].tolist() == [0, -1, 1]
    stats = harness.StatLog(torch.device("cpu"))
    stats.put(0, (torch.tensor(0.5), torch.tensor(7)))
    stats.put(1, (torch.tensor(1.0), torch.tensor(0)))
    frac, rows = stats.read()
    assert frac.tolist() == [0.5, 1.0] and rows.tolist() == [7, 0]


# -- faults planted in the program ----------------------------------------

def _half(real):
    """A classify that leaves the second half of its rows out."""
    def classify(art, x, **kw):
        n = x.shape[0] // 2
        pred, conf = real(art, x[:n], **kw)
        rest = x.shape[0] - n
        return (torch.cat([pred, pred.new_zeros(rest)]),
                torch.cat([conf, conf.new_ones(rest)]))
    return classify


def _flip(real):
    """The answers as produced, one of them altered."""
    def produce(*a, **kw):
        out = real(*a, **kw)
        flat = out.view(-1)
        flat[0] = 1 - flat[0]
        return out
    return produce


@pytest.mark.parametrize("kind", ["records", "stream"])
def test_half_the_batch_left_out_is_caught(kind, monkeypatch):
    from repro_torch.serving import hybrid_serving, stream_serving
    mod = hybrid_serving if kind == "records" else stream_serving
    monkeypatch.setattr(mod, "fused_classify", _half(mod.fused_classify))
    assert small(kind)["correct"] is False


@pytest.mark.parametrize("kind", ["records", "stream"])
def test_an_altered_answer_is_caught(kind, monkeypatch):
    from repro_torch.serving import hybrid_serving, stream_serving
    if kind == "records":
        monkeypatch.setattr(hybrid_serving, "combine",
                            _flip(hybrid_serving.combine))
    else:
        monkeypatch.setattr(stream_serving, "backpatch_pending",
                            _flip(stream_serving.backpatch_pending))
    res = small(kind)
    assert res["correct"] is False and res["failed"] >= 1


def test_a_step_that_keeps_its_state_is_caught(monkeypatch):
    from repro_torch.serving.stream_serving import StreamingHybridServer
    monkeypatch.setattr(StreamingHybridServer, "_store_regs",
                        lambda self, regs, state: None)
    res = small("stream")
    assert res["correct"] is False
    assert res["checks"]["register_words_mismatch"]["value"] > 0


# -- what the command loads and refuses -----------------------------------

def test_the_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "import portbench.run as R\n"
            "a = R.parse_args(['--workload', sys.argv[2], '--seed', '3',"
            " '--seconds', '0.2'])\n"
            "R.run(a, 'cpu')\n"
            "print(R.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), CELLS[1]],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib.xla" in R.forbidden_modules()


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_cli_on_the_card(cuda):
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", CELLS[0], "--seed", "7",
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
