"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell of this benchmark can have. (No cell spans
chips, so the fault of an exchange between chips left out has no cell
to show in.)"""

from __future__ import annotations

import pytest

from benchmark.compare import judge
from benchmark.spec import Cell

from .small import run_small

CELLS = ['fleet65k-churn1', 'fleet65k-churn10']


def _judged(name: str) -> tuple:
    res = run_small(name, seconds=1.0)
    return judge(res['readings'], Cell(name).limits)


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    ok, rows = _judged(name)
    assert ok, rows


@pytest.mark.parametrize('name', CELLS)
def test_state_returned_unchanged(name, monkeypatch):
    from cueball_tpu_torch.parallel import telemetry

    real = telemetry.LiveStep.__call__

    def stuck(self, state, inp):
        _, out, fleet = real(self, state, inp)
        return state, out, fleet
    monkeypatch.setattr(telemetry.LiveStep, '__call__', stuck)
    ok, rows = _judged(name)
    assert not ok, rows


@pytest.mark.parametrize('name', CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    from cueball_tpu_torch.parallel import telemetry

    real = telemetry._partial_sums

    def half(inp, out):
        act = inp.active.clone()
        act[act.shape[0] // 2:] = False
        return real(inp._replace(active=act), out)
    monkeypatch.setattr(telemetry, '_partial_sums', half)
    ok, rows = _judged(name)
    assert not ok, rows


@pytest.mark.parametrize('name', CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    from cueball_tpu_torch.parallel import control

    real = control.control_step

    def altered(state, inp):
        # Row 0 runs CoDel in both configurations, so its target is
        # compared on every tick.
        new_state, decisions, fleet = real(state, inp)
        target = decisions['codel_target'].clone()
        target[0] += 1.0
        return new_state, dict(decisions, codel_target=target), fleet
    monkeypatch.setattr(control, 'control_step', altered)
    ok, rows = _judged(name)
    assert not ok, rows


def test_a_decision_the_pools_never_take(monkeypatch):
    """Pools that refuse every decision keep their CoDel targets, so
    the next ticks gather other inputs than the reference's pools."""
    from benchmark.generators import fleet_ticks as fleet

    monkeypatch.setattr(fleet.SyntheticPool, 'apply_control_decision',
                        lambda self, *a, **kw: False)
    ok, rows = _judged('fleet65k-churn1')
    assert not ok and dict((n, v) for n, v, _ in rows)['input_mismatch'] > 0
