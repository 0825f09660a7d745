"""`correct` at a tiny size on the CPU: the port's plain path agrees with
the reference within each cell's limits; the timed path broken underneath
(a step that leaves its state unchanged, half of the batch left out, an
answer altered where it is made) and the lower-precision control do not."""

import pytest
import torch

from benchmark.tests.tiny_cells import run_tiny, tiny_cell

TRAIN = ["mocapDesk2_enerf.train", "spiral1_nerf.train"]


@pytest.mark.parametrize("name", TRAIN + ["spiral1_nerf.render"])
@pytest.mark.parametrize("seed", [2 ** 31 + 3, 17])
def test_the_port_agrees_with_the_reference(name, seed):
    r = run_tiny(name, seed)
    assert r["correct"], r["checks"]


def _half(fn):
    def half(params, ss, batch, noise, *args, **kw):
        n = next(iter(batch.values())).shape[0]
        cut = {k: v[: n // 2] if v.ndim and v.shape[0] == n else v for k, v in batch.items()}
        nz = {k: v[: n // 2] if v.ndim and v.shape[0] == n else v for k, v in noise.items()}
        return fn(params, ss, cut, nz, *args, **kw)
    return half


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    from enerf_torch.train import state, step

    if fault == "state_unchanged":
        monkeypatch.setattr(state.TrainState, "apply_updates", lambda self: None)
    else:
        monkeypatch.setattr(step, "event_loss_fn", _half(step.event_loss_fn))
        monkeypatch.setattr(step, "frames_loss_fn", _half(step.frames_loss_fn))
    assert not run_tiny(name)["correct"]


def test_an_altered_render_is_not_correct(monkeypatch):
    from enerf_torch.train import trainer

    orig = trainer.render_rays_staged

    def altered(*args, **kw):
        out = orig(*args, **kw)
        out["image"] = out["image"].clone()
        out["image"][:500] += 0.05  # one chunk's answer
        return out

    monkeypatch.setattr(trainer, "render_rays_staged", altered)
    assert not run_tiny("spiral1_nerf.render")["correct"]


def over_a_limit(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_and_the_half_batch_fail_in_the_reference(name):
    cell = tiny_cell(name)
    out = cell.driver.control(cell, 2 ** 31 + 9, torch.device("cpu"))
    assert over_a_limit(out["control"], cell.limits), out
    assert over_a_limit(out["half_batch"], cell.limits), out


def test_the_render_control_fails():
    cell = tiny_cell("spiral1_nerf.render")
    out = cell.driver.control(cell, 2 ** 31 + 9, torch.device("cpu"), views=2)
    assert over_a_limit(out["control"], cell.limits), out
