"""Port parity: the video family (`ops/flow.compute_flow`, the fusion cells,
`RecurrentSegNet`, `compute_video_losses` and the video step) against the
JAX package on the CPU.

- `compute_flow` with a moving camera, pixels without depth, pixels whose
  previous depth does not match (they keep weight 1) and projections out
  of the image: the warped state, weights and points within 1e-5, and the
  gradients of a random projection of the outputs with respect to the
  previous state and weights within 1e-5;
- each cell of `FUSION_CELLS`, and `GRU3DCell`, with random weights: the
  outputs within 1e-5;
- `RecurrentSegNet` at T = 3 on a rendered camera-motion sequence, with
  JAX's weights carried by core/weights: log-probs within 1e-4, labels
  equal, the final `VideoState` within 1e-4;
- `compute_video_losses` within 1e-4 relative in fp32; its gradients
  within 1e-3 of each parameter's largest entry with both packages in
  fp64 (as tests/test_torch_seg_models.py: fp32 ReLU kinks in the VGG16
  trunk fall on either side in the two packages);
- 3 fp32 steps of the video step, the loss trajectory within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import posecnn_tpu.engine.train as jtrain
import posecnn_tpu.models.recurrent as jrec
from posecnn_tpu.core import checkpoint as jckpt
from posecnn_tpu.core.config import cfg_from_dict as jax_cfg_from_dict
from posecnn_tpu.ops.flow import compute_flow as jax_compute_flow
from posecnn_torch.core.config import cfg_from_dict
from posecnn_torch.core.weights import params_from_jax
from posecnn_torch.data.procedural import synthetic_class_library
from posecnn_torch.data.synthetic import SyntheticSceneGenerator, SyntheticSequenceGenerator
from posecnn_torch.engine import train as ttrain
from posecnn_torch.models import recurrent as trec
from posecnn_torch.ops.flow import compute_flow

torch.set_num_threads(1)
T, B, H, W, U, C = 3, 1, 48, 64, 8, 3
K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)


def meta(angle, shift):
    """K, K⁻¹ and a live2world of `angle` rad about y and `shift` m along x."""
    r = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]])
    m = np.zeros(48, np.float32)
    m[:9] = K.ravel()
    m[9:18] = np.linalg.inv(K).ravel()
    m[30:42] = np.concatenate([r, [[shift], [0.01], [0.0]]], 1).ravel()
    return m


def flow_inputs(seed=0):
    rs = np.random.RandomState(seed)
    depth = (1.0 + 0.3 * rs.rand(2, H, W)).astype(np.float32)
    depth[:, :6, :9] = 0.0  # no depth
    depth_prev = depth + 0.005 * rs.randn(2, H, W).astype(np.float32)
    depth_prev[:, 20:30, 20:40] += 0.5  # the previous depth disagrees: unmatched
    kinv = np.linalg.inv(K)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    rays = np.stack([kinv[0, 0] * xs + kinv[0, 2], kinv[1, 1] * ys + kinv[1, 2], np.ones_like(xs)], -1)
    points_prev = (depth_prev[..., None] * rays).astype(np.float32)
    # a turn and a shift large enough to push the image's side out of view
    metas = np.stack([meta(0.05, 0.2), meta(-0.02, -0.05)])
    state = rs.randn(2, H, W, U).astype(np.float32)
    weights = (rs.rand(2, H, W, U) * 60).astype(np.float32)
    return state, weights, points_prev, depth, metas


def test_compute_flow_matches_jax():
    args = flow_inputs()
    want = jax_compute_flow(*(jnp.asarray(a) for a in args))
    tin = [torch.from_numpy(a) for a in args]
    tin[0].requires_grad_(True)
    tin[1].requires_grad_(True)
    got = compute_flow(*tin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5)
    ws = np.asarray(want[1])
    assert (ws == 1.0).all(-1).mean() > 0.1 and (ws != 1.0).any(-1).mean() > 0.3
    # the gradients reach the previous state and weights through the gathers
    rs = np.random.RandomState(1)
    cot = [rs.randn(*np.shape(w)).astype(np.float32) for w in want[:2]]

    def jf(s, wt):
        out = jax_compute_flow(s, wt, *(jnp.asarray(a) for a in args[2:]))
        return jnp.sum(out[0] * cot[0]) + jnp.sum(out[1] * cot[1])

    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(args[0]), jnp.asarray(args[1]))
    (got[0] * torch.from_numpy(cot[0])).sum().add((got[1] * torch.from_numpy(cot[1])).sum()).backward()
    np.testing.assert_allclose(tin[0].grad.numpy(), np.asarray(jg[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tin[1].grad.numpy(), np.asarray(jg[1]), rtol=0, atol=1e-5)


def randomised(params, seed):
    """Every parameter replaced by a N(0, 0.3²) draw: the zero-initialised
    gates would otherwise make the cells trivial."""
    leaves, tree = jax.tree_util.tree_flatten(unfreeze(params))
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        tree, [0.3 * jax.random.normal(k, x.shape) for k, x in zip(keys, leaves)])


@pytest.mark.parametrize("cell", sorted(jrec.FUSION_CELLS) + ["gru3d"])
def test_cells_match_jax(cell):
    rs = np.random.RandomState(2)
    if cell == "gru3d":
        shape = (2, 4, 5, 6, U)
        args = (rs.randn(*shape), (rs.rand(*shape[:-1], 1) > 0.4), rs.randn(*shape))
        jcell, tcell = jrec.GRU3DCell(num_units=U), trec.GRU3DCell(U)
    else:
        shape = (2, 6, 7, U)
        args = (rs.randn(*shape), rs.randn(*shape), 3 * rs.rand(*shape))
        jcell, tcell = jrec.FUSION_CELLS[cell](num_units=U), trec.FUSION_CELLS[cell](U)
    args = [np.asarray(a, np.float32) for a in args]
    params = randomised(jcell.init(jax.random.PRNGKey(0), *args), 3)
    want = jcell.apply(params, *args)
    if params:
        tcell.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    with torch.no_grad():
        got = tcell(*(torch.from_numpy(a) for a in args))
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_fresh_gates_start_at_zero_as_in_jax():
    model = trec.RecurrentSegNet(C, num_units=U)
    from posecnn_torch.models.posecnn import init_weights

    init_weights(model, 0)
    assert torch.count_nonzero(model.fusion.gate.weight) == 0
    gru = trec.GRUOriginalCell(U)
    init_weights(gru, 0)
    assert torch.count_nonzero(gru.gates.weight) == 0 and bool((gru.gates.bias == 1).all())
    assert torch.count_nonzero(gru.candidate.weight) > 0


def sequence(batch=B, seed=6):
    lib = synthetic_class_library(C, 256)
    gen = SyntheticSceneGenerator(lib.points, lib.extents, K, width=W, height=H, seed=seed,
                                  min_objects=2, max_objects=3, point_colors=lib.colors,
                                  point_normals=lib.normals)
    b = SyntheticSequenceGenerator(gen, num_steps=T).minibatch(batch)
    b["label"] = b["label"].astype(np.int32)
    return b


def carried(seq, seed=0, compute_dtype=jnp.float32):
    jm = jrec.RecurrentSegNet(num_classes=C, num_units=U, compute_dtype=compute_dtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), seq["image"], seq["depth"], seq["meta"])
    params = unfreeze(params)
    # a gate away from zero, so the fusion mixes the warped state in
    gate = params["params"]["fusion"]["gate"]
    gate["kernel"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), gate["kernel"].shape)
    tm = trec.RecurrentSegNet(C, num_units=U)
    tm.load_state_dict(params_from_jax(jckpt._flatten(params)), strict=True)
    return jm, tm, params


def test_recurrent_net_matches_jax():
    seq = sequence(batch=2)
    jm, tm, params = carried(seq)
    want_lp, want_lab, want_fin = jax.jit(jm.apply)(params, seq["image"], seq["depth"],
                                                    seq["meta"])
    with torch.no_grad():
        lp, lab, fin = tm(*(torch.from_numpy(seq[k]) for k in ("image", "depth", "meta")))
    assert lp.shape == (T, 2, H, W, C)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    for g, w in zip(fin, want_fin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    assert float(np.asarray(want_fin.weights).max()) > 1.0  # the warp matched pixels


def test_video_losses_and_gradients_match_jax():
    seq = sequence()
    jm, tm, params = carried(seq, seed=2)
    jloss, jaux = jtrain.compute_video_losses(jm, params, seq["image"], seq["depth"],
                                              seq["meta"], seq["label"], C)
    tb = [torch.from_numpy(seq[k]) for k in ("image", "depth", "meta", "label")]
    loss, aux = ttrain.compute_video_losses(tm, *tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(aux["per_step"].detach().numpy(), np.asarray(jaux["per_step"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(aux["labels_pred"].numpy(), np.asarray(jaux["labels_pred"]))

    with jax.enable_x64(True):
        jm64 = jm.clone(compute_dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        blobs = [jnp.asarray(seq[k], jnp.float64) for k in ("image", "depth", "meta")]
        # the scan's carry must keep its dtype: start from an fp64 state
        zeros = jnp.zeros((B, H, W, U), jnp.float64)
        init = jrec.VideoState(zeros, zeros, jnp.zeros((B, H, W, 3), jnp.float64))
        onehot = jax.nn.one_hot(jnp.asarray(seq["label"]), C, dtype=jnp.float32)

        def loss64(p):  # compute_video_losses' formula, from that state
            log_probs = jm64.apply(p, *blobs, initial_state=init)[0]
            ce = -jnp.sum(onehot * log_probs, axis=-1)
            return jnp.mean(jnp.sum(ce, axis=(1, 2, 3)) / (jnp.sum(onehot, axis=(1, 2, 3, 4))
                                                           + 1e-10))

        grads = jax.grad(loss64)(p64)
        want = {k: np.asarray(v, np.float64)
                for k, v in params_from_jax(jckpt._flatten(grads)).items()}
    tm64 = trec.RecurrentSegNet(C, num_units=U, compute_dtype=torch.float64)
    tm64.load_state_dict(tm.state_dict())
    tm64 = tm64.double()
    loss64, _ = ttrain.compute_video_losses(tm64, tb[0].double(), tb[1].double(),
                                            tb[2].double(), tb[3])
    loss64.backward()
    for pname, p in tm64.named_parameters():
        w = want[pname]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-12), err_msg=pname)


def test_video_step_trajectory_matches_jax():
    seq = sequence(seed=8)
    train = {"num_classes": C, "num_units": U, "optimizer": "momentum", "learning_rate": 1e-3,
             "momentum": 0.9, "weight_reg": 1e-4, "grad_clip": 5.0, "num_steps": T}
    top = {"network": "recurrent_seg"}
    jm, tm, params = carried(seq, seed=4)
    jcfg = jax_cfg_from_dict(dict(top, train=train))
    state = jtrain.TrainState(params, jtrain.create_optimizer(jcfg, params).init(params),
                              jnp.zeros((), jnp.int32))
    jstep = jtrain.make_video_train_step(jcfg, jm, C, donate=False)
    jb = {k: jnp.asarray(v) for k, v in seq.items()}
    want = []
    for _ in range(3):
        state, metrics = jstep(state, jb, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    cfg = cfg_from_dict(dict(top, train=train))
    tstate = ttrain.create_train_state(cfg, tm)
    step = ttrain.make_video_train_step(cfg, tm)
    tb = {k: torch.from_numpy(v) for k, v in seq.items()}
    got = [float(step(tstate, tb)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tstate.step == 3 and got[-1] < got[0]
