"""The traceable adaptive solve (``ops.integrate.odeint_adaptive_traced``,
one ``while_loop`` an output interval) against the host loop
(``odeint_adaptive``), on the CPU.

Run eagerly, the loop operator runs the same arithmetic as the host loop:
every tableau, tuple states, the PI controller, decreasing grids, an
exhausted ``max_num_steps`` and a NaN-poisoned field give bitwise the host
loop's outputs and counts.  Under ``torch.export`` (symbolic batch) the
solve traces into the graph and the program gives bitwise the eager host
loop's outputs; the fixed-step and multistep methods unroll.
"""

import numpy as np
import pytest
import torch

from flowfusion_torch.ops.integrate import odeint
from flowfusion_torch.ops.integrate.adaptive import odeint_adaptive, odeint_adaptive_traced
from flowfusion_torch.ops.integrate.tableaus import ADAPTIVE_METHODS

torch.set_num_threads(1)

W = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32))


def field(t, y):
    return torch.tanh(y @ W) * torch.cos(3.0 * t) - 0.3 * y


def aug_field(t, s):
    y, _ = s
    return field(t, y), torch.sum(torch.sin(y), dim=-1)


def _y0(n=9, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32))


def _assert_same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _assert_stats(traced, host):
    assert int(traced.n_func_evals) == host.n_func_evals
    assert int(traced.n_accepted) == host.n_accepted
    assert int(traced.n_rejected) == host.n_rejected
    assert bool(traced.succeeded) == host.succeeded


@pytest.mark.parametrize("method", sorted(ADAPTIVE_METHODS))
def test_traced_solve_is_the_host_loop(method):
    kw = dict(rtol=1e-6, atol=1e-7, method=method)
    ts = [0.0, 0.4, 1.3]
    for fn, y0 in ((field, _y0()), (aug_field, (_y0(), torch.zeros(9)))):
        ys, st = odeint_adaptive(fn, y0, ts, **kw)
        ys_t, st_t = odeint_adaptive_traced(fn, y0, ts, **kw)
        _assert_same(ys_t, ys)
        _assert_stats(st_t, st)


@pytest.mark.parametrize("kw", [
    dict(options={"controller": "pi"}),
    dict(options={"max_num_steps": 3}),
    dict(options={"min_step": 1e-3, "max_step": 0.05}, method="tsit5"),
])
def test_traced_solve_options_and_decreasing_grid(kw):
    kw = {"rtol": 1e-5, "atol": 1e-6, **kw}
    for ts in ([0.0, 1.0], [1.0, 0.2]):
        ys, st = odeint_adaptive(field, _y0(), ts, **kw)
        ys_t, st_t = odeint_adaptive_traced(field, _y0(), ts, **kw)
        _assert_same(ys_t, ys)
        _assert_stats(st_t, st)


def test_traced_solve_nan_poisoned_field():
    """Nothing is accepted: the output is the start state, as the host
    loop's, and the solve reports no success."""
    def poisoned(t, y):
        return y * float("nan")

    kw = dict(rtol=1e-5, atol=1e-6, options={"max_num_steps": 5})
    ys, st = odeint_adaptive(poisoned, _y0(), [0.0, 1.0], **kw)
    ys_t, st_t = odeint_adaptive_traced(poisoned, _y0(), [0.0, 1.0], **kw)
    _assert_same(ys_t, ys)
    _assert_stats(st_t, st)
    assert not bool(st_t.succeeded)


class _Solve(torch.nn.Module):
    def __init__(self, method, state):
        super().__init__()
        self.method, self.state = method, state

    def forward(self, y0):
        if self.state == "tuple":
            (ys, ls), st = odeint(aug_field, (y0, torch.zeros_like(y0[:, 0])), [0.0, 0.7], rtol=1e-6, atol=1e-7,
                                  method=self.method)
            out = ys[-1] + ls[-1][:, None]
        else:
            ys, st = odeint(field, y0, [0.0, 0.7], rtol=1e-6, atol=1e-7, method=self.method)
            out = ys[-1]
        return out if st is None else (out, st.n_func_evals)


@pytest.mark.parametrize("method,state", [
    ("dopri5", "tensor"), ("tsit5", "tuple"), ("bosh3", "tensor"), ("rk4", "tensor"), ("implicit_adams", "tuple"),
])
def test_exported_solve_is_the_eager_host_loop(method, state):
    """odeint inside torch.export takes the traced form (adaptive methods;
    its NFE a tensor) or unrolls (fixed-step and multistep): the program,
    at batch sizes other than the example's, gives the eager host loop's
    outputs bitwise."""
    module = _Solve(method, state)
    b = torch.export.Dim("batch", min=1)
    program = torch.export.export(module, (_y0(8),), dynamic_shapes=({0: b},)).module()
    for n in (5, 17):
        y0 = _y0(n, seed=n)
        got, want = program(y0), module(y0)
        if method in ADAPTIVE_METHODS:
            assert int(got[1]) == want[1]
            got, want = got[0], want[0]
        assert torch.equal(got, want)
