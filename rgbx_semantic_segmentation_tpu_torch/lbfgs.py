"""L-BFGS with a zoom line search: the port's own counterpart of
`optax.lbfgs(learning_rate=lr)` (optax 0.2.6), which the JAX package trains
with (its optim.py). One call of `LBFGS.step` is one optax update:

  1. the memory of the last MEMORY_SIZE (10) parameter and gradient
     differences takes the pair of this step and the last;
  2. the two-loop recursion multiplies the gradient by the inverse-Hessian
     estimate, starting from a scaled identity (`scale_init_precond`:
     <dw, du> / <du, du> of the newest pair, and min(1, 1 / |g|) at the
     first step);
  3. the direction is -lr times that;
  4. the zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6, with
     Hager and Zhang's approximate decrease criterion) picks a step size
     along it, first guess 1, re-evaluating the objective through the
     caller's closure; the parameters move by step size x direction.

This is not torch.optim.LBFGS, which runs up to 20 inner iterations a call
with its own line search: the arithmetic here follows optax's, so that the
port's training steps can be held against the JAX package's.

The optimizer works on the flat vector of its parameters (one fp32 or fp64
vector, the parameters' dtype): its memory is two (MEMORY_SIZE, P) tensors
on the parameters' device, held in the state of the first parameter, so
that the state dict carries it into a checkpoint. The line search's scalar
arithmetic runs on the host, in the parameters' dtype (numpy), as optax's
runs in theirs; each evaluation reads the objective's value and its slope
on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

# optax.lbfgs's defaults (alias.py: scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy="one")) and those of the
# zoom line search (linesearch.py).
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, STEPSIZE_PRECISION, TOL = 2.0, 1e-5, 0.0


@dataclasses.dataclass
class SearchState:
    """The zoom line search's state (optax ZoomLinesearchState), without
    the gradients: every field is a host scalar."""
    count: int
    stepsize: float
    value: float
    slope: float
    value_init: float
    slope_init: float
    decrease_error: float
    interval_found: bool
    done: bool
    failed: bool
    low: float
    value_low: float
    slope_low: float
    high: float
    value_high: float
    slope_high: float
    cubic_ref: float
    value_cubic_ref: float
    safe_stepsize: float
    safe_value: float


class ZoomLinesearch:
    """optax's zoom line search on a line `evaluate(stepsize) -> (value,
    slope)`, in scalar dtype `f` (np.float32 or np.float64)."""

    def __init__(self, f):
        self.f = f

    def run(self, evaluate: Callable, value, slope) -> SearchState:
        f = self.f
        zero = f(0.0)
        state = SearchState(
            count=0, stepsize=zero, value=f(value), slope=f(slope),
            value_init=f(value), slope_init=f(slope),
            decrease_error=f(np.inf), interval_found=False, done=False,
            failed=False,
            low=zero, value_low=f(value), slope_low=f(slope), high=zero,
            value_high=f(value), slope_high=f(slope), cubic_ref=zero,
            value_cubic_ref=f(value), safe_stepsize=zero,
            safe_value=f(value))
        with np.errstate(all="ignore"):
            while not (state.done or state.failed):
                step = self._zoom if state.interval_found else self._search
                state = step(state, evaluate)
                if state.failed:
                    state = self._try_safe_step(state)
        return state

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        f = self.f
        err = value - value_init - f(SLOPE_RTOL) * stepsize * slope_init
        approx = slope - f(2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value - value_init - f(APPROX_DEC_RTOL) * abs(
            value_init)
        err = np.minimum(np.maximum(approx, delta_values), err)
        err = np.maximum(err, f(0.0))
        return f(np.inf) if np.isnan(err) else f(err)

    def _curvature_error(self, slope, slope_init):
        f = self.f
        err = np.maximum(abs(slope) - f(CURV_RTOL) * abs(slope_init), f(0.0))
        return f(np.inf) if np.isnan(err) else f(err)

    def _errors(self, stepsize, value, slope, s: SearchState):
        """(decrease error, the larger of it and the curvature error)."""
        dec = self._decrease_error(stepsize, value, slope, s.value_init,
                                   s.slope_init)
        return dec, max(dec, self._curvature_error(slope, s.slope_init))

    def _search(self, s: SearchState, evaluate) -> SearchState:
        """Algorithm 3.5: grow the step until an interval holds a valid
        one."""
        f = self.f
        new = f(1.0) if s.count == 0 else f(INCREASE_FACTOR) * s.stepsize
        value, slope = (f(v) for v in evaluate(new))
        dec, err = self._errors(new, value, slope, s)
        safe = (new, value) if dec <= TOL else (s.safe_stepsize, s.safe_value)
        set_high = dec > 0.0 or (value >= s.value and s.count > 0)
        set_low = slope >= 0.0 and not set_high
        prev = (s.stepsize, s.value, s.slope)
        cur = (new, value, slope)
        (low, value_low, slope_low), (high, value_high, slope_high) = (
            (cur, prev) if set_low else (prev, cur))
        interval_found = set_high or set_low or err <= TOL
        done = err <= TOL
        failed = s.count + 1 >= MAX_LINESEARCH_STEPS and not done
        return SearchState(
            count=s.count + 1, stepsize=new, value=value, slope=slope,
            value_init=s.value_init, slope_init=s.slope_init,
            decrease_error=dec,
            interval_found=bool(interval_found), done=bool(done),
            failed=bool(failed), low=low, value_low=value_low,
            slope_low=slope_low, high=high, value_high=value_high,
            slope_high=slope_high, cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=safe[0], safe_value=safe[1])

    def _zoom(self, s: SearchState, evaluate) -> SearchState:
        """Algorithm 3.6: shrink the interval by cubic, quadratic or
        bisection steps."""
        f = self.f
        low, high = s.low, s.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = f(0.2) * delta, f(0.1) * delta
        too_small = delta <= f(STEPSIZE_PRECISION)
        mc = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                       s.cubic_ref, s.value_cubic_ref, f)
        use_cubic = left + cubic_chk < mc < right - cubic_chk
        mq = _quadmin(low, s.value_low, s.slope_low, high, s.value_high, f)
        use_quad = not use_cubic and left + quad_chk < mq < right - quad_chk
        middle = (mc if use_cubic else mq if use_quad
                  else (low + high) / f(2.0))
        value, slope = (f(v) for v in evaluate(middle))
        dec, err = self._errors(middle, value, slope, s)
        if dec <= TOL and value < s.safe_value:
            safe_stepsize, safe_value = middle, value
        else:
            safe_stepsize, safe_value = s.safe_stepsize, s.safe_value
        done = err <= TOL
        high_to_middle = dec > 0.0 or value >= s.value_low
        high_to_low = slope * (high - low) >= 0.0 and not high_to_middle
        cur = (middle, value, slope)
        old_low = (low, s.value_low, s.slope_low)
        new_high = cur if high_to_middle else (high, s.value_high,
                                               s.slope_high)
        if high_to_low:
            new_high = old_low
        new_low = old_low if high_to_middle else cur
        cubic = ((high, s.value_high) if high_to_middle or high_to_low
                 else (low, s.value_low))
        failed = ((s.count + 1 >= MAX_LINESEARCH_STEPS
                   or (too_small and safe_stepsize > 0.0)) and not done)
        return SearchState(
            count=s.count + 1, stepsize=middle, value=value, slope=slope,
            value_init=s.value_init, slope_init=s.slope_init,
            decrease_error=dec,
            interval_found=s.interval_found, done=bool(done),
            failed=bool(failed), low=new_low[0], value_low=new_low[1],
            slope_low=new_low[2], high=new_high[0], value_high=new_high[1],
            slope_high=new_high[2], cubic_ref=cubic[0],
            value_cubic_ref=cubic[1], safe_stepsize=safe_stepsize,
            safe_value=safe_value)

    @staticmethod
    def _try_safe_step(s: SearchState) -> SearchState:
        """On failure: the best step with sufficient decrease, if any (or
        none at all where every step left the domain)."""
        if s.safe_stepsize > 0.0 or np.isinf(s.decrease_error):
            return dataclasses.replace(s, stepsize=s.safe_stepsize,
                                       value=s.safe_value)
        return s


def _cubicmin(a, fa, fpa, b, fb, c, fc, f):
    """The minimiser of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; nan where there is none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], f)
    A, B = d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], f) / denom
    radical = B * B - f(3.0) * A * C
    return f(a + (-B + np.sqrt(radical)) / (f(3.0) * A))


def _quadmin(a, fa, fpa, b, fb, f):
    """The minimiser of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return f(a - fpa / (f(2.0) * B))


class LBFGS(torch.optim.Optimizer):
    """optax.lbfgs(learning_rate=lr, memory_size=10, scale_init_precond=
    True) with its zoom line search (see the module docstring).

    `step(closure, value)`: `closure()` evaluates the objective at the
    parameters' current values and leaves its gradient in their `.grad`
    (None counts as zero), returning the value as a 0-d tensor. The step
    expects the gradient at the current parameters in `.grad` already, with
    `value` the objective there; the line search calls the closure at each
    trial point. After the step the parameters hold the accepted point;
    `.grad` holds the last evaluation's. `last_step` records the line
    search's step size, its evaluations and the accepted value."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float):
        super().__init__(params, {"lr": lr})
        if len(self.param_groups) != 1:
            raise ValueError("LBFGS takes one param group")
        self.last_step: Optional[dict] = None

    def _params(self) -> List[torch.nn.Parameter]:
        return self.param_groups[0]["params"]

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([p.grad.reshape(-1) if p.grad is not None
                          else torch.zeros_like(p).reshape(-1)
                          for p in self._params()])

    def _assign(self, flat: torch.Tensor) -> None:
        params = self._params()
        views = torch.split(flat, [p.numel() for p in params])
        torch._foreach_copy_(params, [v.view_as(p)
                                      for v, p in zip(views, params)])

    @torch.no_grad()
    def step(self, closure: Callable[[], torch.Tensor], value):
        params = self._params()
        m, lr = MEMORY_SIZE, self.param_groups[0]["lr"]
        x = torch.cat([p.reshape(-1) for p in params])
        g = self._flat_grad()
        f = np.float64 if x.dtype == torch.float64 else np.float32
        st = self.state[params[0]]
        if not st:
            st["count"] = 0
            st["params"] = torch.zeros_like(x)
            st["updates"] = torch.zeros_like(x)
            st["diff_params"] = x.new_zeros((m,) + x.shape)
            st["diff_updates"] = x.new_zeros((m,) + x.shape)
            st["rho"] = x.new_zeros(m)
        count = st["count"]
        dw_mem, du_mem, rho = st["diff_params"], st["diff_updates"], st["rho"]
        idx, prev = count % m, (count - 1) % m

        # 1. the newest pair into the memory (zeros at the first step)
        if count > 0:
            torch.sub(x, st["params"], out=dw_mem[prev])
            torch.sub(g, st["updates"], out=du_mem[prev])
            dot = torch.dot(du_mem[prev], dw_mem[prev])
            rho[prev] = torch.where(dot == 0.0, 0.0, 1.0 / dot)
            # 2. the initial scale <dw, du> / <du, du>
            den = torch.dot(du_mem[prev], du_mem[prev])
            scale = torch.where(den > 0.0, dot / den, 1.0)
        else:
            dw_mem[prev].zero_()
            du_mem[prev].zero_()
            rho[prev] = 0.0
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)

        # 3. the two-loop recursion, newest pair first on the way in
        order = [(idx + j) % m for j in range(m)]
        vec = g.clone()
        alphas = {}
        for i in reversed(order):
            alphas[i] = rho[i] * torch.dot(dw_mem[i], vec)
            vec.addcmul_(du_mem[i], alphas[i], value=-1.0)
        vec.mul_(scale)
        for i in order:
            beta = rho[i] * torch.dot(du_mem[i], vec)
            vec.addcmul_(dw_mem[i], alphas[i] - beta)
        direction = vec.mul_(-lr)
        st["count"] = count + 1
        st["params"], st["updates"] = x, g

        # 4. the line search along the direction from x
        def point(stepsize):
            # x + stepsize * direction, rounded as optax's add_scale
            return (direction * float(stepsize)).add_(x)

        def evaluate(stepsize):
            self._assign(point(stepsize))
            with torch.enable_grad():
                v = closure()
            slope = torch.dot(self._flat_grad(), direction)
            return float(v), float(slope)

        search = ZoomLinesearch(f).run(evaluate, float(value),
                                       float(torch.dot(direction, g)))
        self._assign(point(search.stepsize))
        self.last_step = {"stepsize": float(search.stepsize),
                          "evaluations": search.count,
                          "value": float(search.value)}
        return value
