"""The port stands alone: it imports neither JAX nor the JAX package nor
``ml_dtypes`` (the card's machine has none of them), its entry points default to CUDA and refuse to run silently on the CPU, and
its kernel modules import where there is no CUDA toolkit."""
import torch_threads  # noqa: F401  (first: one torch thread)
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import tree as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
#: top-level packages the port must not import
FOREIGN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _jax_imports(path):
    """Every import of a FOREIGN package in a file, at any depth
    (imports inside functions count too)."""
    bad = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [f"{os.path.relpath(path, REPO)}: {name}" for name in names
                if name.split(".")[0] in FOREIGN]
    return bad


def test_no_source_file_imports_jax_or_repro():
    bad = [b for path in _py_files() for b in _jax_imports(path)]
    assert not bad, bad


def test_chip_smoke_imports_neither_jax_nor_repro():
    """``chip_smoke.py`` runs where only PyTorch is installed."""
    assert not _jax_imports(os.path.join(REPO, "chip_smoke.py"))


#: the port's examples: they import neither JAX nor the JAX package
EXAMPLES = ("torch_quickstart.py", "torch_serve_batched.py",
            "torch_decentralized_train.py")


def test_examples_import_neither_jax_nor_repro():
    for name in EXAMPLES:
        path = os.path.join(REPO, "examples", name)
        assert os.path.exists(path), name
        assert not _jax_imports(path), name


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda(name):
    """Each example runs on ``cuda`` unless given ``--device cpu``: with
    no card it raises before it computes anything."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(REPO, "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if torch.cuda.is_available():
        assert mod.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_fresh_import_pulls_in_no_jax():
    """Import every port module in a fresh interpreter: no FOREIGN
    package may appear in ``sys.modules`` afterwards."""
    mods = []
    for path in _py_files():
        rel = os.path.relpath(path, os.path.join(REPO, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    assert "repro_torch.core.wireplan" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in {FOREIGN!r})
        print("LEAKED", leaked)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


def test_kernel_modules_import_without_nvcc():
    """Nothing is built at import: the CUDA sources compile at the first
    launch on a card.  With PATH stripped of every compiler the kernel
    modules still import and their CPU paths still run."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels import _build, ops
        y = torch.zeros((32, 512)); u = torch.rand((32, 512))
        p = ops.quantize_payload(y, u, None)
        ops.dequant_combine_payload(p, p, p, y, y, 0.5, 0.25, 1.0)
        print("OK", _build.load.cache_info().currsize)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK 0" in out.stdout


def test_entry_points_default_to_cuda():
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import compression, consensus, problems, topology
    from repro_torch.launch import train
    from repro_torch.models.params import meta_params, params_from_jax
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = reduced(get_config("smollm-135m"))
    tree = T.tree_map(lambda a: np.zeros(a.shape, np.float32), meta_params(
        train.build_train_setup(cfg, device="cpu").defs.storage))
    # the problems hold their data on the device they are built for, and
    # ``run`` steps there: both default to CUDA
    ctors = (problems.paper_2node, problems.paper_4node,
             lambda **kw: problems.paper_circle_problem(3, dim=2, **kw),
             lambda **kw: problems.quadratic_problem([[1.0]], [[0.0]], **kw),
             lambda **kw: problems.decentralized_linear_regression(2, 4,
                                                                   **kw),
             lambda **kw: problems.decentralized_logistic_regression(2, 4,
                                                                     **kw))
    alg = consensus.ADCDGD(topology.paper_fig3(),
                           compression.Int8BlockQuantizer(),
                           consensus.StepSize(0.02))
    cpu = consensus.run(alg, problems.paper_4node(device="cpu"), 2)
    assert cpu["x_final"].shape == (4, 1)
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
        assert train.build_train_setup(cfg).device.type == "cuda"
        for ctor in ctors:
            assert ctor().device.type == "cuda"
        assert consensus.run(alg, problems.paper_4node(), 2)["x_final"] \
            .shape == (4, 1)
        return
    for ctor in ctors:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor()
        assert ctor(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        consensus.run(alg, problems.paper_4node(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_train_setup(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree, train.build_train_setup(
            cfg, device="cpu").defs.storage)
    assert train.build_train_setup(cfg, device="cpu").device.type == "cpu"


def test_train_state_refuses_params_on_another_device():
    """Given parameters must already lie where the setup runs: a tree on
    another device would leave the optimizer and consensus state there."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.models.params import meta_params
    setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                    device="cpu")
    params = T.tree_map(lambda a: a.expand((setup.n_nodes,) + a.shape),
                        meta_params(setup.defs.storage))
    with pytest.raises(ValueError, match="the setup runs on cpu"):
        train.init_train_state(setup, params=params)


def test_unported_architectures_say_so():
    from repro.configs import ARCH_IDS as REFERENCE_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, PORTED, get_config
    assert ARCH_IDS == REFERENCE_ARCH_IDS
    assert set(PORTED) == set(ARCH_IDS) == {
        "smollm-135m", "qwen3-0.6b", "yi-9b", "chameleon-34b", "gemma2-9b",
        "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
        "jamba-v0.1-52b", "whisper-small"}
    for arch in ARCH_IDS:
        assert get_config(arch).arch_id == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")
