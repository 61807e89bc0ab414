"""The optimizer's multi-tensor passes (``ops/adamw.py``) on the CPU: the
plain versions against the per-leaf chain they replace in the trainer, bit
for bit, and the trainer around them (the norm and finite check from one
pass, the module's copies written by the update, the gradients read in the
module's dtype where the update is one pass).  The kernel itself runs on
the card: ``tests/test_torch_kernels_cuda.py::test_adamw_kernel``."""
import io

import pytest
import torch
import torch_parity  # noqa: F401 (one torch thread)

from multimodalvc_tpu_torch.config.configs import OptimizationConfig
from multimodalvc_tpu_torch.ops import adamw
from multimodalvc_tpu_torch.runtime import trainer as ttrainer

# an odd-length leaf (the kernel's scalar tail), a matrix, a vector
SHAPES = {"w": (37, 29), "b": (29,), "odd": (7,)}


def _f32(x):
    return float(torch.tensor(x, dtype=torch.float32))


def per_leaf_chain(params, grads, mu, nu, count, lr, betas, eps, weight_decay, scale, clip,
                   copies):
    """The trainer's chain before the multi-tensor pass: clip_by_global_norm
    with the norm of ``global_norm``, then optax adam (+ the decayed weights)
    leaf by leaf, then each module parameter takes its master's value."""
    grads = {n: g.float() for n, g in grads.items()}
    if clip is not None:
        norm = ttrainer.global_norm(grads.values())
        grads = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in grads.items()}
    b1, b2 = (float(b) for b in betas)
    bc1, bc2 = _f32(1.0 - b1 ** count), _f32(1.0 - b2 ** count)
    step_size = -_f32(lr)
    for name, p in params.items():
        g, m, v = grads[name], mu[name], nu[name]
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        u = u * step_size
        if scale != 1.0:
            u = u * scale
        p.add_(u)
    if copies is not None:
        for n, c in copies.items():
            c.copy_(params[n])


def _leaves(seed, grad_scale, grad_dtype):
    g = torch.Generator().manual_seed(seed)
    params = {n: 0.1 * torch.randn(s, generator=g) for n, s in SHAPES.items()}
    grads = {n: (grad_scale * torch.randn(s, generator=g)).to(grad_dtype)
             for n, s in SHAPES.items()}
    moments = {n: (0.01 * torch.randn(s, generator=g), torch.rand(s, generator=g) * 1e-4)
               for n, s in SHAPES.items()}
    return params, grads, moments


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["clip_off", "clip_on"])
def test_adamw_many_equals_the_per_leaf_chain(grad_dtype, scale, weight_decay, grad_scale):
    """Three updates of ``adamw_many_`` (the norm from ``square_sums_many``,
    a bf16 module copy) against the per-leaf chain from the same state, bit
    for bit: masters, both moments and the copies; the clip engaged (norm
    ~ 100 > 1) and not (~ 0.3)."""
    hyper = dict(lr=2e-4, betas=(0.9, 0.98), eps=1e-8, weight_decay=weight_decay, scale=scale)
    params, _, moments = _leaves(0, grad_scale, grad_dtype)
    mine = {n: p.clone() for n, p in params.items()}
    mu = {n: m.clone() for n, (m, _) in moments.items()}
    nu = {n: v.clone() for n, (_, v) in moments.items()}
    my_mu, my_nu = {n: t.clone() for n, t in mu.items()}, {n: t.clone() for n, t in nu.items()}
    copies = {n: p.to(torch.bfloat16) for n, p in params.items()}
    my_copies = {n: c.clone() for n, c in copies.items()}
    names = list(SHAPES)
    for count in (1, 2, 3):
        _, grads, _ = _leaves(count, grad_scale, grad_dtype)
        per_leaf_chain(params, grads, mu, nu, count, hyper["lr"], hyper["betas"], hyper["eps"],
                       weight_decay, scale, 1.0, copies)
        _, totals, finite = adamw.square_sums_many([grads[n] for n in names])
        norm = torch.sqrt(totals[0])
        assert bool(finite) and (float(norm) > 1.0) == (grad_scale > 1.0)
        adamw.adamw_many_([mine[n] for n in names], [grads[n] for n in names],
                          [my_mu[n] for n in names], [my_nu[n] for n in names], count=count,
                          norm=norm, clip=1.0, copies=[my_copies[n] for n in names], **hyper)
        for n in names:
            for what, a, b in (("master", mine, params), ("mu", my_mu, mu), ("nu", my_nu, nu),
                               ("copy", my_copies, copies)):
                assert torch.equal(a[n], b[n]), (count, what, n)
    assert adamw.adamw_many_.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("groups", [None, [0, 1, 3], [2, 2, 0], [3, 1, 2]])
def test_square_sums_many_gives_global_norm(groups):
    """Each leaf's sum of squares in f32, each group's total added in leaf
    order from zero (``global_norm``'s order: its square root, for one
    group, is ``global_norm`` bit for bit), and the finite flag."""
    _, grads, _ = _leaves(4, 1.0, torch.bfloat16)
    names = list(SHAPES)
    sums, totals, finite = adamw.square_sums_many([grads[n] for n in names], groups)
    assert totals.shape == (adamw.GROUPS,) and bool(finite)
    for i, n in enumerate(names):
        assert torch.equal(sums[i], (grads[n].float() * grads[n].float()).sum())
    if groups is None:
        assert torch.equal(torch.sqrt(totals[0]), ttrainer.global_norm(grads.values()))
    for k in range(adamw.GROUPS):
        want = torch.zeros(())
        for i, n in enumerate(names):
            if (groups or [0] * len(names))[i] == k:
                want = want + (grads[n].float() * grads[n].float()).sum()
        assert torch.equal(totals[k], want), k
    grads["b"][3] = float("inf")
    assert not bool(adamw.square_sums_many([grads[n] for n in names], groups)[2])


def test_leaf_table_layout():
    """The kernel's table: eight words a leaf (pointers, length, dtype codes
    and group), then the first work item of each leaf (CHUNK elements an
    item; an empty leaf takes none) and the total."""
    c = adamw.CHUNK
    sizes = [0, 5, c, c + 1, 3 * c]
    grads = [torch.zeros(k, dtype=torch.bfloat16) for k in sizes]
    masters = [torch.zeros(k) for k in sizes]
    copies = [torch.zeros(k, dtype=torch.float16) for k in sizes]
    words, items = adamw.table_words(grads, [0, 1, 2, 3, 0], masters, masters, masters, copies)
    rows, first = words[:8 * len(sizes)].reshape(-1, 8), words[8 * len(sizes):]
    assert items == 7 and list(first) == [0, 0, 1, 2, 4, 7]
    assert list(rows[:, 5]) == sizes
    assert list(rows[:, 6]) == [1 | 2 << 8 | k << 16 for k in (0, 1, 2, 3, 0)]
    assert list(rows[:, 0]) == [g.data_ptr() for g in grads]
    assert list(rows[:, 4]) == [t.data_ptr() for t in copies]
    words, _ = adamw.table_words(grads[1:2])
    assert words[6] == 1 | 3 << 8 and list(words[1:5]) == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        adamw.table_words(grads[:1])


def _opt(**extra):
    kw = dict(lr=1e-2, optimizer="adamw", weight_decay=0.01, clip_norm=1.0, adam_betas=(0.9, 0.98),
              lr_scheduler="fixed", **extra)
    params, _, _ = _leaves(0, 1.0, torch.float32)
    copies = {n: p.to(torch.bfloat16) for n, p in params.items()}
    return params, copies, ttrainer.build_optimizer(OptimizationConfig(**kw), params,
                                                    copies=copies)


def test_one_square_pass_a_step(monkeypatch):
    """``grad_norm`` then ``update`` on the same gradients run one pass of
    square sums (the norm, the finite check and the clip share it); the
    next step's gradients get their own; the copies follow the masters."""
    calls = []
    real = ttrainer.square_sums_many
    monkeypatch.setattr(ttrainer, "square_sums_many",
                        lambda grads, groups=None: calls.append(1) or real(grads, groups))
    params, copies, opt = _opt()
    for step in range(3):
        _, grads, _ = _leaves(10 + step, 3.0, torch.float32)
        norm = opt.grad_norm(grads)
        assert torch.equal(norm, ttrainer.global_norm(grads.values()))
        assert opt.update(grads, params)
        assert len(calls) == step + 1
        for n, p in params.items():
            assert torch.equal(copies[n], p.to(torch.bfloat16)), n
    _, grads, _ = _leaves(20, 3.0, torch.float32)
    opt.update(grads, params)  # without grad_norm first: a pass of its own
    assert len(calls) == 4 and opt._pass is None


def test_nonfinite_gradient_is_skipped_and_counted():
    """A non-finite element skips the update (masters, moments and copies
    unchanged, the count not advanced) and is counted, as the JAX chain's
    apply_if_finite; the next finite step applies."""
    params, copies, opt = _opt()
    _, grads, _ = _leaves(1, 1.0, torch.float32)
    assert opt.update(grads, params)
    before = ({n: p.clone() for n, p in params.items()},
              {n: t.clone() for n, t in opt.state["mu"].items()})
    grads["odd"][2] = float("nan")
    opt.grad_norm(grads)
    assert not opt.update(grads, params)
    assert (opt.count, opt.notfinite_count, opt.total_notfinite, opt.last_finite) == (1, 1, 1,
                                                                                     False)
    for n, p in params.items():
        assert torch.equal(p, before[0][n]) and torch.equal(copies[n], p.to(torch.bfloat16))
        assert torch.equal(opt.state["mu"][n], before[1][n])
    _, grads, _ = _leaves(2, 1.0, torch.float32)
    assert opt.update(grads, params)
    assert (opt.count, opt.notfinite_count, opt.total_notfinite) == (2, 0, 1)


def test_masked_optimizer_state_dict_round_trip():
    """state_dict keeps its keys and per-leaf f32 tensors; through torch.save
    into a new optimizer it continues as the straight run, bit for bit."""
    params, _, opt = _opt(update_freq=2)
    twin_params, _, twin = _opt(update_freq=2)
    for step in range(4):
        _, grads, _ = _leaves(30 + step, 3.0, torch.float32)
        opt.update(grads, params)
    state = opt.state_dict()
    assert set(state) == {"count", "notfinite_count", "total_notfinite", "last_finite",
                          "mini_step", "gradient_step", "plateau", "mu", "nu", "acc"}
    assert all(t.dtype == torch.float32 and t.shape == SHAPES[n]
               for kind in ("mu", "nu", "acc") for n, t in state[kind].items())
    buf = io.BytesIO()
    torch.save({"opt": state, "params": params}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=False)
    twin.load_state_dict(saved["opt"])
    for n, p in twin_params.items():
        p.copy_(saved["params"][n])
    for step in range(4, 8):
        _, grads, _ = _leaves(30 + step, 3.0, torch.float32)
        opt.update(grads, params)
        twin.update({n: g.clone() for n, g in grads.items()}, twin_params)
    for n in params:
        assert torch.equal(params[n], twin_params[n]), n
        assert torch.equal(opt.state["nu"][n], twin.state["nu"][n]), n


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(29, 37)
        self.b = torch.nn.Linear(37, 7)
        self.unused = torch.nn.Linear(3, 3)  # the loss never reaches it

    def forward(self, x):
        return self.b(torch.tanh(self.a(x)))


@pytest.mark.parametrize("update_freq", [1, 2])
def test_trainer_reads_gradients_in_the_module_dtype_where_the_update_is_one_pass(
        monkeypatch, update_freq):
    """A bf16 module's Trainer with the one-pass update (``fused``, the card's
    path, taken here through the plain versions) hands the update autograd's
    bf16 gradients and zeros of the module's dtype where the loss does not
    reach; the steps equal the f32-gradient steps bit for bit (the pass
    widens each element as ``g.float()`` does); the update writes the
    module's copies, so ``_copy_to_module`` is not called."""
    x = torch.randn(6, 29, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    cfg = OptimizationConfig(lr=1e-2, optimizer="adamw", weight_decay=0.01, clip_norm=1.0,
                             lr_scheduler="fixed", update_freq=update_freq)
    runs, seen, real = {}, [], adamw.adamw_many_plain

    def spy(masters, grads, *a, **k):
        seen.extend(g.dtype for g in grads)
        return real(masters, grads, *a, **k)

    monkeypatch.setattr(adamw, "adamw_many_plain", spy)
    for fused in (False, True):
        seen.clear()
        torch.manual_seed(0)
        module = _Toy().to(torch.bfloat16)
        tr = ttrainer.Trainer(lambda batch, gen: ((module(batch) ** 2).float().mean(), {}),
                              module, cfg)
        assert not tr.optimizer.fused and tr.optimizer.copies is tr.params
        tr.optimizer.base.fused = fused
        monkeypatch.setattr(tr, "_copy_to_module", lambda: pytest.fail("copied twice"))
        metrics = [tr.train_step(x) for _ in range(4)]
        runs[fused] = metrics, {n: m.clone() for n, m in tr.master.items()}
        for n, p in tr.params.items():
            assert torch.equal(p, tr.master[n].to(torch.bfloat16)), n
        assert set(seen) == ({torch.float32} if not fused or update_freq > 1
                             else {torch.bfloat16}), (fused, seen)
    assert runs[True][0] == runs[False][0]
    for n, m in runs[False][1].items():
        assert torch.equal(runs[True][1][n], m), n
