"""The port's five examples (``examples/torch_*.py``) end to end at a small
size on the CPU (``--device cpu``: the kernels' plain versions), checking
the lines each is there to show."""
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _run(name, argv, capsys):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(argv)
    return capsys.readouterr().out


def _value(out, prefix):
    line = next(ln for ln in out.splitlines() if ln.strip().startswith(prefix))
    return float(line.split(" = ")[1].split()[0])


def test_torch_quickstart(capsys):
    out = _run("torch_quickstart", ["--device", "cpu", "--n-docs", "24"],
               capsys)
    chain = [_value(out, k) for k in ("RWMD", "OMR", "ACT-1", "ACT-3",
                                      "ICT", "EMD")]
    assert all(a <= b + 1e-6 for a, b in zip(chain, chain[1:]))
    assert _value(out, "Sinkhorn") >= chain[-1] - 1e-6
    assert "top-5 neighbors of doc 7 on cpu" in out
    assert "ids=[7," in out                         # itself first


def test_torch_text_search(capsys):
    out = _run("torch_text_search", ["--device", "cpu", "--n-docs", "48"],
               capsys)
    for name in ("BoW-cosine", "WCD", "LC-RWMD", "LC-OMR", "LC-ACT-1",
                 "LC-ACT-7"):
        assert f"{name} " in out
    assert "recall@8 vs exact EMD" in out
    parity = [ln for ln in out.splitlines() if "max |diff|" in ln]
    assert len(parity) == 2
    assert float(parity[0].rsplit(":", 1)[1]) < 1e-5
    # the scan engine is bitwise the loop of single queries
    assert parity[1].rstrip().endswith("vs the loop: 0.0")


def test_torch_image_search(capsys):
    out = _run("torch_image_search", ["--device", "cpu", "--n-images", "36"],
               capsys)
    assert "=== sparse" in out and "=== dense" in out
    assert "ALL ZERO: full support overlap" in out
    dense = out.split("=== dense")[1]
    assert "RWMD   precision@8" in dense and "(~chance!)" in dense
    assert (_value(dense, "ACT-7  precision")
            > _value(dense, "RWMD   precision"))
    assert out.count("recall@6 vs exact EMD") == 2


def test_torch_serve_decode(capsys):
    out = _run("torch_serve_decode", ["--device", "cpu", "--batch", "2",
                                      "--gen-len", "4"], capsys)
    assert "gemma3-27b (reduced) on cpu: prefill (2, 32)" in out
    assert "decode 4 x 2 tokens" in out
    assert "EMD retrieval over 128 docs" in out
    assert out.rstrip().endswith("OK")


def test_torch_train_lm(capsys, tmp_path):
    out = _run("torch_train_lm", ["--device", "cpu", "--steps", "120",
                                  "--ckpt-dir", str(tmp_path)], capsys)
    assert "device=cpu: one device" in out
    assert "restarts=1 " in out
    assert "over 120 steps" in out
    assert out.rstrip().endswith("OK")


def test_torch_train_lm_mesh(capsys, tmp_path, monkeypatch):
    """``--mesh 2x2``: four gloo ranks on the CPU, an injected failure
    restored from the leader's checkpoint, every rank's final state bitwise
    the failure-free run's. The ranks import the example by name (spawn),
    as they import ``__main__`` when it runs as a script."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    module = importlib.import_module("torch_train_lm")
    module.main(["--device", "cpu", "--mesh", "2x2", "--steps", "16",
                 "--fail-at", "9", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh=(2 data, 2 model) over gloo, 4 ranks on cpu, mode tp" in out
    assert "restarts=1 " in out and "over 16 steps" in out
    assert "each rank holds 45056 of the model's 180224 parameters" in out
    assert "final state bitwise the failure-free mesh run on every rank" \
        in out
    assert out.rstrip().endswith("OK")


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_text_search",
                                  "torch_image_search",
                                  "torch_serve_decode", "torch_train_lm"])
def test_examples_import_no_jax(name):
    source = (EXAMPLES / f"{name}.py").read_text()
    assert "import jax" not in source and "from repro." not in source \
        and "import repro\n" not in source
