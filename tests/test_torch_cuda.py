"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip without one.  The file imports no JAX, so it runs
where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Quantize payloads must be byte-equal; the combine within 1 ulp (it is
bitwise equal on an H100: both sides round every product and sum).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import dequant_combine as D
from repro_torch.kernels import quantize as Q
from repro_torch.launch import train

BLOCK = 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_quantize_kernel_matches_plain(cuda_device, dtype, step):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    y = (torch.randn((4099, BLOCK), generator=g, device=cuda_device)
         * 0.05).to(dtype)
    u = torch.rand((4099, BLOCK), generator=g, device=cuda_device)
    before = Q.quantize_payload.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        assert torch.equal(Q.quantize_payload(y, u, step, **view),
                           Q.quantize_payload_plain(y, u, step, **view))
    assert Q.quantize_payload.launches == before + 2


@pytest.mark.cuda
def test_cuda_dequant_combine_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rows = 4099
    u = torch.rand((rows, BLOCK), generator=g, device=cuda_device)
    pays = [Q.quantize_payload(torch.randn((rows, BLOCK), generator=g,
                                           device=cuda_device), u, None)
            for _ in range(3)]
    xt = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    m = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        got = D.dequant_combine_payload(*pays, xt, m, 0.5, 0.25, 0.37, **view)
        want = D.dequant_combine_payload_plain(*pays, xt, m, 0.5, 0.25, 0.37,
                                               **view)
        for a, b in zip(got, want):
            np.testing.assert_array_max_ulp(a.cpu().numpy(), b.cpu().numpy(),
                                            maxulp=1)


@pytest.mark.cuda
def test_cuda_train_step_launches_each_kernel_once_per_node(cuda_device):
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=4,
                                    device=cuda_device)
    state = train.init_train_state(setup, 0)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 8,
                               n_shards=4).global_batch_arrays(0)
    before = (Q.quantize_payload.launches,
              D.dequant_combine_payload.launches)
    state, metrics = train.train_step(setup, state, batch)
    torch.cuda.synchronize()
    assert (Q.quantize_payload.launches - before[0],
            D.dequant_combine_payload.launches - before[1]) == (4, 4)
    assert np.isfinite(metrics["loss"])
    assert state["consensus"]["x_tilde"].device.type == "cuda"
