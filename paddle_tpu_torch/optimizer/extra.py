"""ASGD / NAdam / RAdam / Rprop / LBFGS.

The port of ``paddle_tpu/optimizer/extra.py``: pure per-parameter updates
on the shared ``Optimizer`` base with the JAX package's formulas, and
LBFGS with its closure ``step`` and strong-Wolfe line search over the
flattened parameter vector (history kept as tensors on the parameters'
device; its convergence tests read values on the host). None of them
has a fused kernel: their steps run the per-parameter loop, counted by
``fused_step`` under the reason ``optimizer_type`` (LBFGS, whose
``step`` takes a closure, under ``optimizer``).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["ASGD", "NAdam", "RAdam", "Rprop", "LBFGS"]


class ASGD(Optimizer):
    """Stochastic Average Gradient:

        i = m % n;  d = d - y_i + g;  y_i = g
        x = x - lr * (d / min(m+1, n) + lambda * x)

    State per param: running sum ``d`` and an ``[n, *shape]`` gradient
    history ``ys`` (n = batch_num).
    """

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if batch_num < 1:
            raise ValueError(f"batch_num must be >= 1, got {batch_num}")
        self._batch_num = int(batch_num)
        self._multi_precision = multi_precision

    def _init_state(self, p):
        n = self._batch_num
        s = {"d": torch.zeros_like(p, dtype=torch.float32),
             "ys": torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                               device=p.device),
             "m": torch.zeros((), dtype=torch.int32, device=p.device)}
        if self._multi_precision and p.dtype != torch.float32:
            s["master"] = p.float()
        return s

    def _update(self, p, g, state, lr, index=None):
        n = self._batch_num
        g = g.float()
        m = state["m"]
        i = (m % n).long().reshape(1)
        y_i = state["ys"].index_select(0, i)[0]
        d = state["d"] - y_i + g
        ys = state["ys"].index_copy(0, i, g[None])
        p32 = state.get("master", p.float())
        denom = torch.clamp(m + 1, max=n).float()
        upd = d / denom + self._weight_decay * p32
        new_p32 = p32 - lr * upd
        out = {"d": d, "ys": ys, "m": m + 1}
        if "master" in state:
            out["master"] = new_p32
        return new_p32.to(p.dtype), out


class NAdam(Optimizer):
    """Nesterov Adam, psi = momentum_decay (0.004):

        mu_t     = beta1 * (1 - 0.5 * 0.96^(t * psi))
        mu_{t+1} = beta1 * (1 - 0.5 * 0.96^((t+1) * psi))
        m_t = beta1 m + (1-beta1) g ; v_t = beta2 v + (1-beta2) g^2
        m_hat = mu_{t+1} m_t / (1 - mu_prod_{t+1}) + (1-mu_t) g / (1 - mu_prod_t)
        v_hat = v_t / (1 - beta2^t)
        p = p - lr * m_hat / (sqrt(v_hat) + eps)
    """

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta2_pow": one.clone(), "mu_product": one.clone(),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, lr, index=None):
        b1, b2, eps, psi = self._beta1, self._beta2, self._epsilon, self._psi
        g = g.float()
        p32 = p.float()
        if self._weight_decay:
            g = g + self._weight_decay * p32
        t = state["t"] + 1
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * psi))
        mu_t1 = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * psi))
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        mu_prod = state["mu_product"] * mu_t
        mu_prod1 = mu_prod * mu_t1
        b2p = state["beta2_pow"] * b2
        m_hat = mu_t1 * m / (1 - mu_prod1) + (1 - mu_t) * g / (1 - mu_prod)
        v_hat = v / (1 - b2p)
        new_p = (p32 - lr * m_hat / (torch.sqrt(v_hat) + eps)).to(p.dtype)
        return new_p, {"moment1": m, "moment2": v, "beta2_pow": b2p,
                       "mu_product": mu_prod, "t": t}


class RAdam(Optimizer):
    """Rectified Adam:

        rho_inf = 2/(1-beta2) - 1
        rho_t   = rho_inf - 2 t beta2^t / (1 - beta2^t)
        m_hat   = m_t / (1 - beta1^t)
        if rho_t > 5:  r_t = sqrt(((rho_t-4)(rho_t-2) rho_inf) /
                                  ((rho_inf-4)(rho_inf-2) rho_t))
                       p -= lr * m_hat * r_t / (sqrt(v_hat) + eps)
        else:          p -= lr * m_hat
    """

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": one.clone(), "beta2_pow": one.clone(),
                "t": torch.zeros((), dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, lr, index=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = g.float()
        p32 = p.float()
        if self._weight_decay:
            g = g + self._weight_decay * p32
        t = state["t"] + 1
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2.0 * t * b2p / (1 - b2p)
        m_hat = m / (1 - b1p)
        v_hat = torch.sqrt(v / (1 - b2p))
        r_t = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf) /
                         torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t,
                                     min=eps))
        rectified = p32 - lr * m_hat * r_t / (v_hat + eps)
        plain = p32 - lr * m_hat
        new_p = torch.where(rho_t > 5.0, rectified, plain).to(p.dtype)
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p,
                       "beta2_pow": b2p, "t": t}


class Rprop(Optimizer):
    """Resilient backprop: per-weight step sizes adapted by gradient sign
    agreement; sign-flip steps shrink by eta_minus and the gradient is
    zeroed for that step (so the next sign product is 0)."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        lo, hi = learning_rate_range
        if not (0.0 < lo <= learning_rate <= hi):
            raise ValueError(
                f"need 0 < {lo} <= learning_rate={learning_rate} <= {hi}")
        self._lr_range = (float(lo), float(hi))
        if not (0.0 < etas[0] < 1.0 < etas[1]):
            raise ValueError(f"need 0 < eta_minus < 1 < eta_plus, got {etas}")
        self._etas = (float(etas[0]), float(etas[1]))
        self._multi_precision = multi_precision

    def _init_state(self, p):
        s = {"prev_grad": torch.zeros_like(p, dtype=torch.float32),
             "step_size": torch.full_like(p, float(self.get_lr()),
                                          dtype=torch.float32)}
        if self._multi_precision and p.dtype != torch.float32:
            s["master"] = p.float()
        return s

    def _update(self, p, g, state, lr, index=None):
        lo, hi = self._lr_range
        eta_m, eta_p = self._etas
        g = g.float()
        sign = g * state["prev_grad"]
        factor = torch.where(sign > 0, eta_p,
                             torch.where(sign < 0, eta_m, 1.0))
        step = torch.clamp(state["step_size"] * factor, lo, hi)
        g_eff = torch.where(sign < 0, 0.0, g)
        p32 = state.get("master", p.float())
        new_p32 = p32 - torch.sign(g_eff) * step
        out = {"prev_grad": g_eff, "step_size": step}
        if "master" in state:
            out["master"] = new_p32
        return new_p32.to(p.dtype), out


class LBFGS(Optimizer):
    """Limited-memory BFGS with a closure-based step and an optional
    strong-Wolfe line search (``step(closure)``). Operates on the
    flattened parameter vector; history (s, y, rho) kept per step."""

    # closure-driven multi-evaluation step with host-side convergence
    # tests: not one fused update
    _fusable_step = False

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None else max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', "
                f"got {line_search_fn!r}")
        self._line_search_fn = line_search_fn
        self._hist_s: list = []
        self._hist_y: list = []
        self._hist_rho: list = []

    # -- flat views ----------------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _gather_flat_grad(self):
        """Flatten grads with the base-class weight_decay / regularizer /
        grad_clip contract applied."""
        params_grads = [(p, p.grad if p.grad is not None
                         else torch.zeros_like(p)) for p in self._params()]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        outs = []
        for p, g in params_grads:
            gd = self._apply_regularizer(p, g.float())
            if self._weight_decay:
                gd = gd + self._weight_decay * p.float()
            outs.append(gd.reshape(-1))
        return torch.cat(outs) if outs else torch.zeros((0,))

    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _gather_flat_params(self):
        return torch.cat([p.float().reshape(-1) for p in self._params()])

    # -- two-loop recursion --------------------------------------------------
    def _direction(self, flat_grad):
        q = -flat_grad
        if not self._hist_s:
            return q
        alphas = []
        for s, y, rho in zip(reversed(self._hist_s), reversed(self._hist_y),
                             reversed(self._hist_rho)):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        s, y = self._hist_s[-1], self._hist_y[-1]
        gamma = torch.dot(s, y) / torch.clamp(torch.dot(y, y), min=1e-30)
        q = gamma * q
        for (s, y, rho), a in zip(zip(self._hist_s, self._hist_y,
                                      self._hist_rho), reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def _eval_closure(self, closure, x, d, t):
        self._set_flat_params(x + t * d)
        loss_v = float(closure())
        return loss_v, self._gather_flat_grad()

    def _strong_wolfe(self, closure, x, d, t, f0, g0, c1=1e-4, c2=0.9,
                      max_ls=25):
        """Bracketing strong-Wolfe line search on phi(t) = f(x + t d)."""
        dg0 = float(torch.dot(g0, d))
        f_prev, t_prev = f0, 0.0
        f_t, g_t = self._eval_closure(closure, x, d, t)
        evals = 1
        lo, hi = None, None
        for _ in range(max_ls):
            dg_t = float(torch.dot(g_t, d))
            if f_t > f0 + c1 * t * dg0 or (evals > 1 and f_t >= f_prev):
                lo, hi = (t_prev, f_prev), (t, f_t)
                break
            if abs(dg_t) <= -c2 * dg0:
                return t, f_t, g_t, evals
            if dg_t >= 0:
                lo, hi = (t, f_t), (t_prev, f_prev)
                break
            t_prev, f_prev = t, f_t
            t = min(t * 2.0, 1e10)
            f_t, g_t = self._eval_closure(closure, x, d, t)
            evals += 1
        if lo is None:  # never bracketed: accept last
            return t, f_t, g_t, evals
        # zoom by bisection
        for _ in range(max_ls):
            t = 0.5 * (lo[0] + hi[0])
            f_t, g_t = self._eval_closure(closure, x, d, t)
            evals += 1
            dg_t = float(torch.dot(g_t, d))
            if f_t > f0 + c1 * t * dg0 or f_t >= lo[1]:
                hi = (t, f_t)
            else:
                if abs(dg_t) <= -c2 * dg0:
                    break
                if dg_t * (hi[0] - lo[0]) >= 0:
                    hi = lo
                lo = (t, f_t)
            if abs(hi[0] - lo[0]) < self._tol_change:
                break
        return t, f_t, g_t, evals

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the "
                             "loss")
        self._global_step += 1

        def run_closure():
            with torch.enable_grad():
                return closure()

        loss = run_closure()
        loss_v = float(loss)
        flat_grad = self._gather_flat_grad()
        evals = 1
        lr = self.get_lr()
        for _ in range(self._max_iter):
            if float(torch.max(torch.abs(flat_grad))) <= self._tol_grad:
                break
            d = self._direction(flat_grad)
            x = self._gather_flat_params()
            t = lr if self._hist_s else min(1.0, 1.0 / max(
                float(torch.sum(torch.abs(flat_grad))), 1e-30)) * lr
            if self._line_search_fn == "strong_wolfe":
                t, new_loss, new_grad, n_evals = self._strong_wolfe(
                    closure=run_closure, x=x, d=d, t=t, f0=loss_v,
                    g0=flat_grad)
                evals += n_evals
                self._set_flat_params(x + t * d)
            else:
                self._set_flat_params(x + t * d)
                new_loss = float(run_closure())
                new_grad = self._gather_flat_grad()
                evals += 1
            s = t * d
            y = new_grad - flat_grad
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(self._hist_s) >= self._history_size:
                    self._hist_s.pop(0)
                    self._hist_y.pop(0)
                    self._hist_rho.pop(0)
                self._hist_s.append(s)
                self._hist_y.append(y)
                self._hist_rho.append(1.0 / ys)
            if abs(new_loss - loss_v) < self._tol_change:
                loss_v, flat_grad = new_loss, new_grad
                break
            loss_v, flat_grad = new_loss, new_grad
            if evals >= self._max_eval:
                break
        return loss
