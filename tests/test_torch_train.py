"""The whole slice: 4 nodes x 3 steps of SGD + ADC-DGD held to the JAX
composition of the same parts.

The reference's trainer cannot run the ADC path on this JAX version
(``shard_map`` rejects the out_specs of the norm leaves), so one subprocess
with 4 host devices composes it from its parts: per-node loss and
gradients from the single-device ``T.train_loss``, ``repro.optim.Sgd``,
then ``ConsensusRuntime.exchange`` under ``shard_map`` with the noise
passed in.  The port runs ``repro_torch.launch.train.train_step`` from the
same weights (``params_from_jax``) on the same batches and noise.

Tolerance, in grid steps of the fixed quantizer (``fixed_step0 / k``):
float32 gradients sum in different orders, so now and then a stochastic
rounding lands on the other side of its threshold and moves one element by
one grid step.  Parameters and ``x_tilde`` may therefore differ by at most
``MAX_GRID_STEPS`` grid steps of step 1 (the largest), in at most
``MAX_FRAC_OFF`` of the elements; everything else agrees to float32
rounding, as do the losses (``LOSS_RTOL``).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
FIXED_STEP0 = 1e-3
MAX_GRID_STEPS = 2.0
MAX_FRAC_OFF = 1e-4
LOSS_RTOL = 1e-5

BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro import optim as joptim
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.data import SyntheticLMDataset
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.launch import train
from repro_torch.models.params import params_from_jax

N, STEPS, LR, B, S = 4, __STEPS__, 1e-2, 8, 64
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)
cfg = jreduced(jget_config("smollm-135m"))
ldefs = JT.build_defs(cfg, local_context())
p0 = jax.device_get(JT.init_params(ldefs, jax.random.PRNGKey(0)))
ds = SyntheticLMDataset(cfg.vocab_size, S, B, n_shards=N)
layout = jwire.WireLayout.for_tree(p0)

def noise(k):
    return np.random.default_rng([5, k]).random(
        (N, layout.n_rows, 512), dtype=np.float32)

# ---- the reference, composed from its parts ------------------------------
jrt = JRt(JCfg(quant_mode="fixed"), ctx)
grad_fn = jax.jit(jax.value_and_grad(
    lambda p, b: JT.train_loss(p, ldefs, b, local_context()), has_aux=True))
sgd, sched = joptim.Sgd(), joptim.constant_schedule(LR)
x = jax.tree.map(lambda a: np.broadcast_to(a, (N,) + a.shape).copy(), p0)
pspec = jax.tree.map(lambda a: P("data"), x)
cspec = {"x_tilde": P("data", None, None), "m_agg": P("data", None, None)}
js = jax.jit(shard_map_compat(
    lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)), mesh,
    in_specs=(pspec,), out_specs=cspec, check=False))(x)
def jstep(xp, xh, s, k, nz):
    xn, s2, _ = jrt.exchange(xp, xh, jax.tree.map(lambda a: a[0], s), k,
                             jax.random.PRNGKey(7), noise=nz[0])
    return xn, jax.tree.map(lambda a: a[None], s2)
step_f = jax.jit(shard_map_compat(
    jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
    out_specs=(pspec, cspec), check=False))
jlosses = []
for k in range(1, STEPS + 1):
    batch = ds.global_batch_arrays(k - 1)
    bn = B // N
    outs = [grad_fn(jax.tree.map(lambda a: a[i], x),
                    {kk: jnp.asarray(v[i * bn:(i + 1) * bn])
                     for kk, v in batch.items()}) for i in range(N)]
    jlosses.append([float(o[0][0]) for o in outs])
    grads = jax.tree.map(lambda *g: jnp.stack(g), *[o[1] for o in outs])
    x_half, _ = sgd.step((), jax.tree.map(jnp.asarray, x), grads,
                         sched(jnp.asarray(k, jnp.int32)))
    x, js = step_f(x, x_half, js, jnp.asarray(k, jnp.int32), noise(k))
    x = jax.device_get(x)

# ---- the port --------------------------------------------------------------
setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                consensus_nodes=N, lr=LR, device="cpu")
state = train.init_train_state(setup, params=params_from_jax(
    p0, setup.defs.storage, device="cpu", n_nodes=N))
tlosses = []
for k in range(1, STEPS + 1):
    state, m = train.train_step(setup, state, ds.global_batch_arrays(k - 1),
                                noise=torch.from_numpy(noise(k)))
    tlosses.append(m["node_loss"].tolist())

def compare(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), int((d > 1e-5).sum()), int(d.size)

leaves = [compare(a, b) for a, b in zip(
    T.tree_leaves(state["params"]), jax.tree_util.tree_leaves(x))]
xt = compare(state["consensus"]["x_tilde"], js["x_tilde"])
print("RESULT " + json.dumps({
    "jlosses": jlosses, "tlosses": tlosses,
    "param_max": max(l[0] for l in leaves),
    "param_frac_off": sum(l[1] for l in leaves) / sum(l[2] for l in leaves),
    "xt_max": xt[0], "xt_frac_off": xt[1] / xt[2]}))
"""


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", BODY.replace("__STEPS__", str(STEPS))],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


def test_losses_match_every_step(result):
    for got, want in zip(result["tlosses"], result["jlosses"]):
        assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("what", ["param", "xt"])
def test_state_within_grid_steps(result, what):
    assert result[f"{what}_max"] <= MAX_GRID_STEPS * FIXED_STEP0
    assert result[f"{what}_frac_off"] <= MAX_FRAC_OFF
