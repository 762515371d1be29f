"""A run with the timed path broken underneath must come out not correct:
each cell kind at the small size on the CPU (the run's look for a card
skipped), with the cells' own limits, once for each fault the cell can
have. One chip: no exchange between chips to leave out."""

import pytest
import torch

from benchmark.tests import tiny


def test_sound_runs_are_correct():
    assert tiny.run("base.video-576x1024").correct
    assert tiny.run("bbox.train-320x576").correct


def _video_faults(monkeypatch, fault):
    from posetraj_torch.pipeline import svd_controlnet as sc

    step = sc._denoise_step
    if fault == "state_unchanged":
        monkeypatch.setattr(sc, "_denoise_step", lambda p, b, c, lat, *a: lat.float())
    elif fault == "half_batch":  # the CFG batch's unconditional half left out: the conditional alone
        def cond_only(p, b, c, lat, img, clip, ids, hint, gs, *a):
            return step(p, b, c, lat, img, clip, ids, hint, torch.ones_like(gs), *a)
        monkeypatch.setattr(sc, "_denoise_step", cond_only)
    else:  # an answer altered where it is produced: one decoded frame shifted
        decode = sc.decode_latents

        def altered(*a, **k):
            out = decode(*a, **k)
            out[:, -1] += 0.1
            return out
        monkeypatch.setattr(sc, "decode_latents", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_video_faults_are_not_correct(monkeypatch, fault):
    _video_faults(monkeypatch, fault)
    assert not tiny.run("base.video-576x1024").correct


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "blend_factors_frozen"])
def test_training_faults_are_not_correct(monkeypatch, fault):
    from posetraj_torch.train import trainer as tm

    acc = tm._accumulate
    if fault == "state_unchanged":
        monkeypatch.setattr(tm, "sync_step", lambda state, tcfg, mesh=None: None)
    elif fault == "half_batch":  # the window's second micro-batch left out, the mean over the first
        monkeypatch.setattr(tm, "_accumulate", lambda state, tcfg, grads: acc(
            state, tcfg, [None if g is None else g * 2.0 for g in grads]) if state.step % 2 == 0 else None)
    elif fault == "blend_factors_frozen":  # the one-element leaves detached: no gradient reaches them
        monkeypatch.setattr(tm, "_accumulate", lambda state, tcfg, grads: acc(
            state, tcfg, [None if g is None or g.numel() == 1 else g for g in grads]))
    else:  # the loss altered where it is produced
        loss = tm.edm_training_loss

        def altered(*a, **k):
            value, metrics = loss(*a, **k)
            metrics["loss"] = metrics["loss"] * 1.5
            return value * 1.5, metrics
        monkeypatch.setattr(tm, "edm_training_loss", altered)
    assert not tiny.run("bbox.train-320x576").correct
