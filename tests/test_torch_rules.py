"""Rules the port keeps: it imports neither JAX nor the JAX package, its
entry points run on CUDA unless asked for the CPU, and its kernels build
from source or raise (no fallback)."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root == "repro" or root == "jax" or root.startswith("jax") or root == "jaxlib"


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("repro", "jax", "jaxlib") or m.startswith("jax"))
        print(len(names), bad)
        assert not bad, bad
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 15       # every module was imported


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path}:{node.lineno} imports {name}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks what happens without a CUDA device")


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.core.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.retrieval import Retriever, RetrieverConfig

    enc = serve.make_bert_dual_encoder(serve.tiny_bert())
    params = enc.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever(enc, params, RetrieverConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n-passages", "16", "--n-queries", "2"])
    assert Retriever(enc, params, RetrieverConfig(), device="cpu").device.type == "cpu"


def test_train_entry_point_raises_without_cuda_unless_asked_for_the_cpu(no_cuda):
    from repro_torch.launch import train

    args = ["--total-batch", "8", "--local-batch", "4", "--bank", "8", "--steps", "1",
            "--corpus-size", "16"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)
    _, report = train.main(args + ["--device", "cpu"])
    assert report.steps_run == 1


def test_params_and_state_take_their_device_explicitly():
    """No path builds parameters on the CPU by omission: the device is a
    required argument of init_bert, DualEncoder.init and init_state."""
    import inspect

    from repro_torch.core.step_program import init_state
    from repro_torch.launch import serve
    from repro_torch.models.bert import init_bert

    enc = serve.make_bert_dual_encoder(serve.tiny_bert())
    for fn in (init_bert, enc.init, init_state):
        param = inspect.signature(fn).parameters["device"]
        assert param.default is inspect.Parameter.empty, fn
    with pytest.raises(TypeError):
        enc.init(torch.Generator().manual_seed(0))


def test_build_cell_raises_without_cuda_unless_asked_for_the_cpu(no_cuda):
    from repro_torch.launch import steps

    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("dcn-v2", "train_batch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("deepfm", "serve_p99", "cuda")
    assert steps.build_cell("dcn-v2", "train_batch", device="cpu").kind == "recsys_train"


def test_embedding_bag_raises_for_a_device_tensor_when_its_build_fails(monkeypatch, tmp_path):
    """Any tensor not on the CPU goes to the kernel: with no nvcc the call
    raises, and the plain version never runs (a meta tensor stands in for a
    CUDA one, which this machine cannot make)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops

    def plain(*args):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(ops, "embedding_bag_ref", plain)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else real_isfile(p))
    ops._library.cache_clear()
    table = torch.empty((8, 4), device="meta")
    idx = torch.zeros((3,), dtype=torch.int32, device="meta")
    before = ops.embedding_bag.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._EmbeddingBag.apply(table, idx, idx, 2)
    assert ops.embedding_bag.launches == before
    ops._library.cache_clear()


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("fused_topk")
    assert not (tmp_path / "kernels").exists()


def test_kernel_sources_exist_and_build_dir_is_ignored():
    from repro_torch.kernels import _build

    lib = _build.library_path("fused_topk")
    assert lib.parent == REPO / "build" / "kernels"
    assert lib.name.startswith("libfused_topk-") and lib.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_to_run_without_cuda(no_cuda):
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_port_dtype_literals_stay_in_precision():
    """The repo's dtype lint (tools/reprolint RPL001) holds for the port:
    numpy float dtypes are spelled only in core/precision.py."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from tools.reprolint import run_reprolint

    res = run_reprolint([str(PORT)], root=str(REPO), tests_dir=str(REPO / "tests"))
    assert res.ok, res.format()
