"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``): the 16 update rules as registered
ops, each returning the new weight and the new states out of place, as
the JAX op does (``nd.sgd_update(w, g, out=w, ...)`` rebinds ``w`` to
the result, as every op's ``out=`` does). The gradient is prepared in
the JAX op's order: rescale, then clip, then ``+ wd * w`` (``signsgd``,
``signum``, ``ftrl`` and ``group_adagrad`` add no weight decay there;
``ftml`` adds it before the clip). The rules that the optimizers apply
in place in the train step (SGD with and without momentum or an f32
master, Adam, AdaGrad, GroupAdaGrad) are written once, in place (the
``*_update_`` functions here, which :mod:`optimizer.optimizer` calls);
their ops run them on copies."""
from __future__ import annotations

import torch

from .registry import alias, register


def _clip(g, clip):
    return g.clamp(-clip, clip) if clip is not None and clip > 0 else g


# ------------------------------------ in place, for the optimizers
def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


@torch.no_grad()
def sgd_update_(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """w -= lr * g, in place."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    weight.sub_(lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update_(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; w += mom, in place."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def mp_sgd_update_(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w32 -= lr * g on the f32 master, then w = w32 rounded, in
    place."""
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    weight32.sub_(lr * g)
    weight.copy_(weight32)
    return weight, weight32


@torch.no_grad()
def mp_sgd_mom_update_(weight, grad, mom, weight32, *, lr, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; w32 += mom on the f32 master, then
    w = w32 rounded, in place."""
    g = _prep(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    mom.mul_(momentum).sub_(lr * g)
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight, mom, weight32


@torch.no_grad()
def adagrad_update_(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """history += g^2; w -= lr * g / sqrt(history + eps), in place."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    history.add_(g.square())
    weight.sub_(lr * g / (history + epsilon).sqrt())
    return weight, history


@torch.no_grad()
def group_adagrad_update_(weight, grad, history, *, lr, epsilon=1e-5,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """One accumulator per row: history += mean(g^2 over the row);
    w -= lr * g / sqrt(history + eps), in place. ``history`` is (N,) or
    (N, 1) and keeps its layout."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    axes = tuple(range(1, g.dim()))
    ssq = g.square().mean(dim=axes) if axes else g.square()
    history.add_(ssq.reshape(history.shape))
    bshape = tuple(weight.shape[:1]) + (1,) * len(axes)
    weight.sub_(lr * g / (history.reshape(bshape) + epsilon).sqrt())
    return weight, history


@torch.no_grad()
def adam_update_(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """The moments and w -= lr * mean / (sqrt(var) + eps), in place
    (``lr`` already carries the bias correction)."""
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * g.square())
    weight.sub_(lr * mean / (var.sqrt() + epsilon))
    return weight, mean, var


# ------------------------------------------------------------- the ops
@register("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False):
    return sgd_update_(weight.clone(), grad, lr=lr, wd=wd,
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient)


@register("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    return sgd_mom_update_(weight.clone(), grad, mom.clone(), lr=lr,
                           momentum=momentum, wd=wd,
                           rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)


@register("nag_mom_update", num_outputs=2)
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):
    return adam_update_(weight.clone(), grad, mean.clone(), var.clone(),
                        lr=lr, beta1=beta1, beta2=beta2, epsilon=epsilon,
                        wd=wd, rescale_grad=rescale_grad,
                        clip_gradient=clip_gradient)


@register("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = _clip(weight - lr * g / torch.sqrt(new_n + epsilon),
                  clip_weights)
    return new_w, new_n


@register("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g_acc, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_acc
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return (_clip(weight + new_delta, clip_weights), new_n, new_g,
            new_delta)


@register("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("adagrad_update", num_outputs=2)
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    return adagrad_update_(weight.clone(), grad, history.clone(), lr=lr,
                           epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)


# the lazy row update is the AdaGrad optimizer's; on dense tensors the op
# is adagrad_update
alias("adagrad_update", "_sparse_adagrad_update")


@register("adadelta_update", num_outputs=3)
def adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
        new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


@register("ftml_update", num_outputs=4)
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (
        torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("mp_sgd_update", num_outputs=2)
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False):
    """SGD on the f32 master ``weight32``; the weight is its rounding."""
    return mp_sgd_update_(weight.clone(), grad, weight32.clone(), lr=lr,
                          wd=wd, rescale_grad=rescale_grad,
                          clip_gradient=clip_gradient)


@register("mp_sgd_mom_update", num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False):
    return mp_sgd_mom_update_(weight.clone(), grad, mom.clone(),
                              weight32.clone(), lr=lr, momentum=momentum,
                              wd=wd, rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)


@register("group_adagrad_update", num_outputs=2)
def group_adagrad_update(weight, grad, history, *, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0):
    return group_adagrad_update_(weight.clone(), grad, history.clone(),
                                 lr=lr, epsilon=epsilon,
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
alias("group_adagrad_update", "_contrib_group_adagrad_update")
