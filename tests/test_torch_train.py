"""Port parity of scene training: AdamW, scene_loss with its gradients and
fit_scene (repro_torch.optim.adamw, repro_torch.core.train) against the JAX
package (repro.optim.adamw, repro.core.train). Inputs come from the
reference (jax.random scenes, numpy-seeded arrays), carried over as numpy.

Tolerances: AdamW given the same gradients rtol 1e-6; the loss rtol 1e-4
and each gradient field max-abs within 1e-4 of that field's largest
magnitude (here 6e-6 and 3e-6 are seen; chip_smoke's train_grad_vs_host
holds the card to the host with the same bounds, where a few alpha and
early-exit gates flip); fit_scene's losses rtol 1e-4 and PSNRs within 1e-3
dB over 3 steps. Adam's steps are not compared
elementwise: its first step moves a parameter whose gradient is at noise
level by +-lr, whatever the gradient's size."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_camera as j_make_camera, random_scene as j_random_scene
from repro.core.gaussians import GaussianScene as JScene
from repro.core.pipeline import RenderConfig as JConfig, render as j_render
from repro.core import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch.core import camera, pipeline, raster, train
from repro_torch.core.gaussians import SCENE_FIELDS, GaussianScene, scene_from_numpy
from repro_torch.optim import adamw_init, adamw_update
from torch_parity import n, t

ADAM_RTOL = 1e-6
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4
FIT_LOSS_RTOL = 1e-4
FIT_PSNR_ATOL = 1e-3

CFG_KW = dict(tile=16, group=32, group_capacity=256, tile_capacity=256, span=4)
CAM_ARGS = [((0.0, 0.8, 3.5), (0, 0, 0), 64, 64), ((2.5, 0.8, 2.5), (0, 0, 0), 64, 64)]
LAM = jtrain.SceneTrainConfig().lambda_dssim


# -- AdamW ---------------------------------------------------------------------

def _arrays(seed, n_gauss=50):
    rng = np.random.default_rng(seed)
    shapes = dict(means3d=(n_gauss, 3), log_scales=(n_gauss, 3), quats=(n_gauss, 4),
                  opacity=(n_gauss,), sh=(n_gauss, 1, 3))
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


LRS = dict(means3d=1.6e-3, log_scales=5e-3, quats=1e-3, opacity=5e-2, sh=2.5e-3)


@pytest.mark.parametrize("lr_kind", ["per_leaf", "scalar", "schedule"])
def test_adamw_matches_reference(lr_kind):
    """Three steps from the same parameters, given the same gradients."""
    if lr_kind == "per_leaf":
        j_lr = JScene(**{k: jnp.float32(v) for k, v in LRS.items()})
        t_lr = GaussianScene(**LRS)
    elif lr_kind == "scalar":
        j_lr = t_lr = 3e-3
    else:
        j_lr = lambda s: 1e-2 / (1.0 + jnp.asarray(s, jnp.float32))
        t_lr = lambda s: 1e-2 / (1.0 + torch.as_tensor(s, dtype=torch.float32))
    start = _arrays(0)
    jp = JScene(**{k: jnp.asarray(v) for k, v in start.items()})
    tp = GaussianScene(**{k: torch.from_numpy(v) for k, v in start.items()})
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    for i in range(3):
        grads = _arrays(10 + i)
        grads["opacity"][:5] = 0.0  # leaves with no gradient
        jp, js = jadamw.adamw_update(
            jp, JScene(**{k: jnp.asarray(v) for k, v in grads.items()}), js, jnp.int32(i),
            lr=j_lr, weight_decay=0.01)
        tp, ts = adamw_update(
            tp, GaussianScene(**{k: torch.from_numpy(v) for k, v in grads.items()}), ts, i,
            lr=t_lr, weight_decay=0.01)
        for k in SCENE_FIELDS:
            for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
                g = getattr(got, k)
                assert g.dtype == torch.float32
                np.testing.assert_allclose(n(g), np.asarray(getattr(want, k)),
                                           rtol=ADAM_RTOL, atol=0, err_msg=f"step {i} {k}")


# -- scene_loss and its gradients -----------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """The reference test's target scene, cameras, config and perturbation
    (tests/test_scene_training.py), with the targets rendered by JAX."""
    target_scene = j_random_scene(jax.random.key(0), 150, extent=2.0)
    cams = [j_make_camera(*a) for a in CAM_ARGS]
    cfg = JConfig(**CFG_KW)
    targets = [j_render(target_scene, c, cfg).image for c in cams]
    init = dataclasses.replace(
        target_scene,
        means3d=target_scene.means3d
        + 0.05 * jax.random.normal(jax.random.key(1), target_scene.means3d.shape),
        opacity=target_scene.opacity - 0.5,
    )
    return dict(init=init, cams=cams, cfg=cfg, targets=targets)


def _port(problem):
    """The same problem on the port, on the CPU."""
    return dict(
        init=scene_from_numpy(problem["init"], "cpu"),
        cams=[camera.make_camera(*a) for a in CAM_ARGS],
        cfg=pipeline.RenderConfig(**CFG_KW),
        targets=[t(x) for x in problem["targets"]],
    )


@pytest.fixture(scope="module")
def jax_loss_and_grads(problem):
    fn = jax.jit(jax.value_and_grad(
        lambda s: jtrain.scene_loss(s, problem["cams"][0], problem["targets"][0],
                                    problem["cfg"], LAM), has_aux=True))
    (loss, img), grads = fn(problem["init"])
    return float(loss), np.asarray(img), {k: np.asarray(getattr(grads, k)) for k in SCENE_FIELDS}


def _port_loss_and_grads(port):
    leaves = train.trainable(port["init"])
    loss, img = train.scene_loss(leaves, port["cams"][0], port["targets"][0], port["cfg"], LAM)
    grads = torch.autograd.grad(loss, [getattr(leaves, k) for k in SCENE_FIELDS])
    return loss.detach(), img.detach(), dict(zip(SCENE_FIELDS, grads))


def test_scene_loss_and_gradients_match_jax(problem, jax_loss_and_grads):
    want_loss, want_img, want_grads = jax_loss_and_grads
    loss, img, grads = _port_loss_and_grads(_port(problem))
    np.testing.assert_allclose(n(img), want_img, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for k in SCENE_FIELDS:
        g, w = n(grads[k]), want_grads[k]
        scale = np.abs(w).max()
        assert scale > 0, f"{k}: the reference's gradient is all zero"
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (k, np.abs(g - w).max(), scale)


def test_recomputed_raster_matches_direct_chunks(problem, monkeypatch):
    """The checkpointed chunks give the gradients, image and counters of the
    same chunk function called directly, bit for bit; and the forward under
    autograd is the image of an inference-mode render."""
    port = _port(problem)
    loss_r, img_r, grads_r = _port_loss_and_grads(port)
    with torch.inference_mode():
        plain = pipeline.render(port["init"], port["cams"][0], port["cfg"])
    calls = []

    def direct(fn, *args, **kwargs):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(raster.torch.utils.checkpoint, "checkpoint", direct)
    loss_d, img_d, grads_d = _port_loss_and_grads(port)
    assert calls and all(fn is raster.blend_chunk for fn in calls)
    assert torch.equal(img_r, img_d) and torch.equal(img_r, plain.image)
    assert torch.equal(loss_r, loss_d)
    for k in SCENE_FIELDS:
        assert torch.equal(grads_r[k], grads_d[k]), k


def test_counters_unchanged_under_autograd(problem):
    """Recording a graph (identify, bin, bitmask and compact under no_grad,
    the raster chunks recomputed) changes no counter."""
    port = _port(problem)
    for mode in ("gstg", "tile_baseline", "group_baseline"):
        cfg = dataclasses.replace(port["cfg"], mode=mode)
        got = pipeline.render(train.trainable(port["init"]), port["cams"][1], cfg)
        with torch.inference_mode():
            want = pipeline.render(port["init"], port["cams"][1], cfg)
        assert got.image.requires_grad
        assert torch.equal(got.image.detach(), want.image)
        assert got.stats.as_dict() == want.stats.as_dict()


def test_cuda_backend_refuses_to_train(problem):
    port = _port(problem)
    cam, cfg = port["cams"][0], dataclasses.replace(port["cfg"], backend="cuda")
    leaves = train.trainable(port["init"])
    for mode in ("gstg", "tile_baseline"):
        with pytest.raises(RuntimeError, match="record no gradient"):
            train.scene_loss(leaves, cam, port["targets"][0],
                             dataclasses.replace(cfg, mode=mode), LAM)
    # Without a graph to record, the cuda backend renders as before.
    with torch.no_grad():
        graphless = pipeline.render(leaves, cam, cfg)
    plain = pipeline.render(port["init"], cam, cfg)
    assert torch.equal(graphless.image, plain.image)


# -- fit_scene -------------------------------------------------------------------

def test_fit_scene_matches_reference(problem):
    """Three steps over two cameras: the history's losses and PSNRs."""
    steps = 3
    _, want = jtrain.fit_scene(problem["init"], problem["cams"], problem["targets"],
                               problem["cfg"], jtrain.SceneTrainConfig(steps=steps),
                               log_every=1)
    port = _port(problem)
    fitted, got = train.fit_scene(port["init"], port["cams"], port["targets"], port["cfg"],
                                  train.SceneTrainConfig(steps=steps), log_every=1)
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(steps))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=FIT_LOSS_RTOL)
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0, atol=FIT_PSNR_ATOL)
    for k in SCENE_FIELDS:
        assert not getattr(fitted, k).requires_grad
        assert torch.isfinite(getattr(fitted, k)).all()


@pytest.mark.slow
def test_fit_scene_improves_psnr(problem):
    """Port of tests/test_scene_training.py::test_fit_scene_improves_psnr."""
    port = _port(problem)
    tcfg = train.SceneTrainConfig(steps=40)
    fitted, history = train.fit_scene(port["init"], port["cams"], port["targets"],
                                      port["cfg"], tcfg, log_every=10)
    assert history[-1]["psnr"] > history[0]["psnr"] + 1.0
    assert history[-1]["loss"] < history[0]["loss"]
