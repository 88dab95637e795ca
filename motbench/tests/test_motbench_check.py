"""The check on the CPU at the tiny cell: a sound run is correct; the
control and each fault a cell can have, planted under the timed path,
come out not correct. (One chip: no exchange between chips to leave
out.)"""
from unittest import mock

import pytest
import torch

from tests_support import tiny_run


def verdict(**kwargs):
    result, lines = tiny_run(**kwargs)
    return result['correct'], {k: c['value'] for k, c in
                               result['checks'].items()}


def test_sound_run_is_correct():
    ok, numbers = verdict()
    assert ok, numbers
    assert numbers['gap_mean_px'] == 0.0 and numbers['assoc_mean_px'] == 0.0


def test_control_is_not_correct():
    """The program's int8 networks and the tracker's state in bfloat16."""
    ok, numbers = verdict(control='int8')
    assert not ok, numbers
    assert numbers['det_heads_rel'] > 0.05
    assert numbers['reid_crops_off'] > 0.1
    assert numbers['gap_mean_px'] > 0.1


def _unchanged(prog):
    """Gap frames commit nothing: the state comes back as it went in."""
    from fastmot_tpu_torch.ops import gap_commit as gc
    real = gc.gap_commit

    def fake(cfg, spec, age_penalty, confirm_hits, states, *args):
        _, infos = real(cfg, spec, age_penalty, confirm_hits, states, *args)
        return states, infos
    return mock.patch.object(gc, 'gap_commit', fake)


def _half_batch(prog):
    """The ReID batch embeds the first half of the streams only."""
    from fastmot_tpu_torch import feature_extractor as fe
    real = fe.extract_core

    def fake(module, out_hw, frame, tlbrs, valid):
        half = frame.shape[0] // 2
        emb = real(module, out_hw, frame[:half], tlbrs[:half], valid[:half])
        return torch.cat([emb, torch.zeros((frame.shape[0] - half,)
                                           + emb.shape[1:])])
    return mock.patch.object(fe, 'extract_core', fake)


def _altered(prog):
    """The association's commit moves every box a pixel to the right."""
    from fastmot_tpu_torch.ops import assoc_commit as ac
    real = ac.assoc_commit

    def fake(*args):
        state, hist, info = real(*args)
        means = state[0].clone()
        means[..., 0] += 1.0
        return (means,) + tuple(state[1:]), hist, info
    from fastmot_tpu_torch import tracker
    return mock.patch.object(tracker.ac, 'assoc_commit', fake)


@pytest.mark.parametrize('fault, number', [
    (_unchanged, 'gap_mean_px'), (_half_batch, 'reid_crops_off'),
    (_altered, 'assoc_mean_px')])
def test_fault_is_not_correct(fault, number):
    patches = []

    def plant(prog):
        p = fault(prog)
        p.start()
        patches.append(p)
    try:
        ok, numbers = verdict(fault=plant)
    finally:
        for p in patches:
            p.stop()
    assert not ok, numbers
    assert numbers[number] > 0, numbers
