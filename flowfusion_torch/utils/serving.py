"""Serving artifacts: a model's likelihood or sampler as a ``torch.export`` program.

Counterpart of the JAX package's ``utils/serving.py``.  A model's
log-density (or its deterministic base -> data sampler) is traced once into
an ``ExportedProgram`` whose parameters, standardization statistics, solver
and trace-estimator configuration are baked in, saved to bytes inside a
provenance envelope, and served without the model code:

    blob = serving.export_log_prob(model, batch=None)      # symbolic batch
    f = serving.deserialize_log_prob(blob)
    lp = f(x, seed=7)                                      # (B,) densities

What the program holds.  The adaptive solves trace as one ``while_loop``
each (``ops.integrate.odeint_adaptive_traced``, the host loop's arithmetic);
the fixed-step and multistep methods unroll.  Every RHS evaluation is a
registered op, ``flowfusion_torch::fused_mlp`` or
``flowfusion_torch::fused_sketch``: on a ``"cuda"`` artifact it launches the
hand-written kernel, on a ``"cpu"`` artifact it runs the plain version of
the same folded operands.  Loading an artifact needs those ops registered
(``flowfusion_torch.kernels``) and none of the model code.

PRNG discipline.  Probes and auxiliary momenta are inputs of the program,
never drawn inside it.  The deserialized callable keeps the JAX signature
``f(x[, conditional], seed=0)``: it draws them from
``torch.Generator(device).manual_seed(seed)`` exactly as the eager
``log_prob(x, generator=...)`` does, so the same seed gives the same
densities.  Torch's streams are not JAX's: the same seed draws other probes
in the two packages.

Platforms are ``"cuda"`` and ``"cpu"`` (default: the model's device).  An
exported program holds its weights on one device, so one artifact serves
one platform: a mixed ``("cuda", "cpu")`` export raises, and so does
``"tpu"``.  An explicit ``use_fused_kernel=True`` for a CPU target raises
(a CPU artifact cannot launch the kernel).  On a CPU target the likelihood
still takes the op (its plain CPU kernel), because ``torch.func.jvp``,
which the plain path's divergence uses, does not trace inside a
``while_loop``; the samplers trace the plain path.  The JAX package's
guards against TPU compiler crashes have no counterpart here and are not
ported.

Symbolic batch.  The port's kernels plan their grid at run time, so a
symbolic-batch export on the card keeps the kernel (the JAX package's
Pallas kernels needed a concrete grid and fell back to plain XLA).

TF32.  A program does not record ``torch.backends.cuda.matmul.allow_tf32``;
the deserialized callables run under ``torch.no_grad()`` and
``_device.strict_fp32_matmul()``, so the plain matrix products beside the
kernel (the embedding fold) stay strict float32 whatever the caller set,
and the step counts are the eager solve's.

AOTInductor packaging is out of scope: it needs the ops registered in C++
(``TORCH_LIBRARY``), not in Python.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import types
import warnings
from typing import Callable, Optional, Sequence

import torch

from .._device import strict_fp32_matmul

__all__ = [
    "ExportRefused",
    "export_log_prob",
    "export_log_prob_bucketed",
    "deserialize_log_prob",
    "deserialize_log_prob_bucketed",
    "export_sampler",
    "deserialize_sampler",
    "save_artifact",
    "load_artifact",
]

PLATFORMS = ("cuda", "cpu")
_CALL_FILE = "flowfusion_call.json"  # the call's metadata, inside the saved program


class ExportRefused(ValueError):
    """An export configuration was refused by the serving guards (a
    platform the port does not serve, a mixed-platform export, or an
    explicit flag the target cannot honour).

    A dedicated type so callers (e.g. the CLI) can translate guard
    refusals into flag advice without swallowing unrelated
    ``ValueError``s raised during closure construction or tracing.
    """


# ---------------------------------------------------------------------------
# the models: families, dimensions, targets
# ---------------------------------------------------------------------------


def _families():
    from ..models.flow import ODEFlow
    from ..models.population import PopulationModelDiffusion
    from ..models.score import ScoreModel
    from ..models.symplectic import SymplecticFlowModel

    return ScoreModel, ODEFlow, PopulationModelDiffusion, SymplecticFlowModel


def _check_model(model) -> None:
    if not isinstance(model, _families()):
        raise TypeError(
            f"unsupported model type {type(model).__name__}; serving exports "
            "cover ScoreModel, ODEFlow, PopulationModelDiffusion and "
            "SymplecticFlowModel"
        )


def _inner(model):
    """The object that carries the net and ``use_fused_kernel``: the score
    model of a population wrapper, else the model."""
    return getattr(model, "score_model", model)


def _set_kernel(model, value):
    """``model`` with ``use_fused_kernel`` = ``value`` (the population
    wrapper's on its score model)."""
    inner = _inner(model)
    if inner is not model:
        return dataclasses.replace(model, score_model=dataclasses.replace(inner, use_fused_kernel=value))
    return dataclasses.replace(model, use_fused_kernel=value)


def _data_dim(model) -> int:
    net = _inner(model).net
    for attr in ("n_dimensions", "target_dimension", "n_data_dims"):
        if hasattr(net, attr):
            return getattr(net, attr)
    raise TypeError(f"cannot infer data dimension from {type(net).__name__}")


def _cond_dim(model) -> int:
    net = _inner(model).net
    for attr in ("n_conditionals", "conditional_dimension"):
        if hasattr(net, attr):
            return getattr(net, attr)
    return 0


def _device(model) -> torch.device:
    params = _inner(model).params
    return params["layers" if "layers" in params else "q_layers"][0]["w"].device


def _target_platforms(platforms, model) -> set:
    """The platforms an export will serve: ``platforms`` when given, else
    the model's device type."""
    if isinstance(platforms, (str, bytes)):
        # a bare "cuda" would otherwise iterate as {'c','u','d','a'}
        raise TypeError(
            f"platforms must be a sequence of platform names, got the "
            f"bare string {platforms!r} — pass platforms=({platforms!r},)"
        )
    if platforms:
        return {str(p).lower() for p in platforms}
    return {_device(model).type}


def _align_to_target(model, platforms, likelihood: bool):
    """The model configured for the artifact's one target platform, or an
    ``ExportRefused``.

    * ``"tpu"`` and other names: the port serves ``"cuda"`` and ``"cpu"``;
    * more than one target: one program holds its weights on one device
      (and a ``"cuda"`` program launches the kernel ops);
    * the model must live on the target's device;
    * ``"cpu"``: an explicit ``use_fused_kernel=True`` is refused (the JAX
      package's refusal of a kernel on a non-TPU target); a likelihood takes
      the op, whose CPU kernel is the plain version (the plain path's
      ``torch.func.jvp`` does not trace in a ``while_loop``), a sampler the
      plain path;
    * ``"cuda"``: the model as configured (auto dispatch launches the
      kernel); a likelihood on the plain path is refused, for the reason
      above.
    """
    targets = _target_platforms(platforms, model)
    unknown = sorted(targets - set(PLATFORMS))
    if unknown:
        raise ExportRefused(
            f"the port serves platforms {PLATFORMS}; got {unknown} — export "
            "TPU artifacts with the JAX package"
        )
    if len(targets) > 1:
        raise ExportRefused(
            "one artifact cannot serve both 'cuda' and 'cpu': an exported "
            "program holds its weights on one device, and a 'cuda' program "
            "launches the kernel ops — export one artifact per platform"
        )
    (target,) = targets
    device = _device(model)
    if device.type != target:
        raise ExportRefused(
            f"the model's parameters are on {device} but the target platform "
            f"is {target!r}: move the model to the target's device first"
        )
    use = _inner(model).use_fused_kernel
    if target == "cpu":
        if use is True:
            raise ExportRefused(
                "use_fused_kernel=True asks for the CUDA kernel, which a "
                "'cpu' artifact cannot launch — export for platforms=('cuda',) "
                "from a model on the card, or drop the explicit flag"
            )
        if likelihood and use is None:
            return _set_kernel(model, True)
        return _set_kernel(model, False)
    if likelihood and use is False:
        raise ExportRefused(
            "use_fused_kernel=False puts the plain path's divergence "
            "(torch.func.jvp) inside the solver's while_loop, which "
            "torch.export cannot trace — keep the kernel for a 'cuda' artifact"
        )
    return model


# ---------------------------------------------------------------------------
# the traced closures
# ---------------------------------------------------------------------------


def _draw_spec(model) -> dict:
    """How the serving callable draws what the program takes besides the
    data: ``{"kind": "momentum"}`` for the symplectic family, else the
    trace estimator and its probe counts (``ops.trace.make_probes``)."""
    from ..models.symplectic import SymplecticFlowModel

    if isinstance(model, SymplecticFlowModel):
        return {"kind": "momentum"}
    inner = _inner(model)
    return {"kind": "probes", "trace_mode": inner.trace_mode, "hpp_rank": inner.hpp_rank,
            "hpp_vecs": inner.hpp_vecs, "xt_vecs": inner.xt_vecs}


def _draw(spec: dict, x: torch.Tensor, seed: int) -> tuple:
    """The probes (or the momentum) of one call, from
    ``torch.Generator(x.device).manual_seed(seed)``, as the eager
    ``log_prob(x, generator=...)`` draws them."""
    from ..ops import trace as trace_lib

    gen = torch.Generator(x.device).manual_seed(int(seed))
    if spec["kind"] == "momentum":
        return (torch.randn(x.shape, generator=gen, device=gen.device).to(x.device),)
    return trace_lib.make_probes(spec["trace_mode"], gen, x, hpp_rank=spec["hpp_rank"],
                                 hpp_vecs=spec["hpp_vecs"], xt_vecs=spec["xt_vecs"])


def _logprob_closure(model, atol, rtol, method, options, has_cond, volume_corrected):
    """``(x, cond, probes) -> lp`` with the model baked in, dispatching on
    the family's ``log_prob`` signature; ``probes`` is the symplectic
    family's ``(momentum,)``."""
    from ..models.symplectic import SymplecticFlowModel

    ScoreModel, ODEFlow, PopulationModelDiffusion, _ = _families()
    kw = dict(atol=atol, rtol=rtol, method=method, options=options)

    if isinstance(model, PopulationModelDiffusion):

        def fn(x, cond, probes):
            return model.log_prob(x, conditional=cond, probes=probes, volume_corrected=volume_corrected, **kw)[0]

    elif isinstance(model, (ScoreModel, ODEFlow)):

        def fn(x, cond, probes):
            return model.log_prob(x, conditional=cond, probes=probes, **kw)[0]

    elif isinstance(model, SymplecticFlowModel):

        def fn(x, cond, probes):
            return model.log_prob(x, conditional=cond, momentum=probes[0], **kw)[0]

    else:
        raise TypeError(f"unsupported model type {type(model).__name__}")

    if has_cond:
        return fn
    return lambda x, probes: fn(x, None, probes)


def _sampler_closure(model, atol, rtol, method, options, has_cond):
    """``(base[, cond]) -> samples``: the deterministic base -> data map of
    each family (probability-flow ODE / CNF / symplectic fixed step).

    ``atol``/``rtol`` of None mean each family's own sampling defaults
    (score: 1e-4, flow: torchdiffeq's 1e-9/1e-7); explicit tolerances are
    rejected where a family cannot honour them rather than dropped."""
    ScoreModel, ODEFlow, PopulationModelDiffusion, SymplecticFlowModel = _families()
    tols = {k: v for k, v in (("atol", atol), ("rtol", rtol)) if v is not None}

    if isinstance(model, ScoreModel):

        def fn(base, cond):
            return model.sample_ode_from_base(base, conditional=cond, method=method, options=options, **tols)[0]

    elif isinstance(model, ODEFlow):

        def fn(base, cond):
            return model.sample(base, conditional=cond, method=method, options=options, **tols)[0]

    elif isinstance(model, PopulationModelDiffusion):
        if tols:
            raise ValueError(
                "the population wrapper pins sampling tolerances to 1e-5 "
                "(reference parity) — drop atol/rtol for this family"
            )

        def fn(base, cond):
            return model.forward(base, conditional=cond, method=method, options=options)[0]

    elif isinstance(model, SymplecticFlowModel):
        # fixed-step family: the stepper comes from options ('euler',
        # 'leapfrog', ...), not the adaptive `method` arg
        if tols or method != "dopri5":
            raise ValueError(
                "the symplectic sampler is fixed-step: configure it with "
                "options={'num_steps': k, 'method': 'euler' | 'leapfrog'}"
            )
        steps = (options or {}).get("num_steps", 1)
        stepper = (options or {}).get("method", "euler")

        def fn(base, cond):
            return model.sample((base.shape[0], base.shape[1] // 2), conditional=cond, num_steps=steps,
                                method=stepper, base=base)

    else:
        raise TypeError(f"unsupported model type {type(model).__name__}")

    if has_cond:
        return fn
    return lambda base: fn(base, None)


class _Program(torch.nn.Module):
    """The closure as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args: tuple, batch_dims: tuple, batch: Optional[int], call: dict, platforms, device) -> bytes:
    """Trace ``fn`` on ``args`` into an ``ExportedProgram`` (the batch
    symbolic when ``batch`` is None: ``batch_dims`` gives each argument's
    batch axis), save it with the call's metadata (``what`` it computes,
    how to ``draw`` its probes) and wrap it in the provenance envelope."""
    if batch is None:
        b = torch.export.Dim("batch", min=1)
        shapes = tuple(_dims(a, d, b) for a, d in zip(args, batch_dims))
    else:
        shapes = None
    _forget_loop_compiles()
    # the forward's *args are one input of the traced module
    program = torch.export.export(_Program(fn), args, dynamic_shapes=None if shapes is None else (shapes,))
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_CALL_FILE: json.dumps(call)})
    return _wrap_provenance(buf.getvalue(), platforms, device.type)


def _forget_loop_compiles():
    """Drop what earlier exports compiled of ``while_loop``, so that an
    export does not depend on what the process exported before.

    Inside ``torch.export`` a ``while_loop`` is compiled by dynamo through
    one wrapper function of torch's (``_while_loop_op_wrapper``, a code
    object shared by every loop of every export), and dynamo keeps each
    compile on that code object with its guards.  The next export looks
    its loops up in that cache: the guards of a pinned batch-4 export,
    checked against a symbolic batch, add ``batch != 4`` to the new
    export's shapes, and a symbolic export then fails with a constraint
    violation.  Removing the wrapper's entries before each export is local
    to the loops: a caller's own ``torch.compile``d functions keep theirs
    (``torch._dynamo.reset()`` would clear those too)."""
    from torch._dynamo.eval_frame import remove_from_cache
    from torch._higher_order_ops.while_loop import while_loop
    for code in while_loop.__code__.co_consts:
        if isinstance(code, types.CodeType):
            remove_from_cache(code)


def _dims(arg, axis, b):
    """The dynamic-shape spec of one argument: ``{axis: b}``, or a tuple of
    them for a tuple argument with a tuple of axes."""
    if isinstance(arg, tuple):
        return tuple(_dims(a, ax, b) for a, ax in zip(arg, axis))
    return {axis: b}


def _load(payload: bytes):
    """``(ExportedProgram, call metadata)`` of a saved program; loading
    registers the kernel ops first."""
    from .. import kernels  # noqa: F401  (registers flowfusion_torch::fused_mlp, ::fused_sketch)
    from ..kernels import fused_mlp, fused_sketch  # noqa: F401

    extra = {_CALL_FILE: ""}
    program = torch.export.load(io.BytesIO(bytes(payload)), extra_files=extra)
    return program, json.loads(extra[_CALL_FILE])


def _run(module, *args):
    """One call of a loaded program: no autograd, strict float32 matrix
    products (the eager solves' settings; a program does not record them)."""
    with torch.no_grad(), strict_fp32_matmul():
        return module(*args)


# ---------------------------------------------------------------------------
# likelihood
# ---------------------------------------------------------------------------


def export_log_prob(
    model,
    *,
    batch: Optional[int] = None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    method: str = "dopri5",
    options: Optional[dict] = None,
    volume_corrected: bool = False,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize ``model``'s log-density entry point as a serving artifact.

    ``batch=None`` exports a symbolic batch dimension (one artifact, any
    batch size, the kernel kept on the card); a concrete ``batch`` pins the
    shape.  ``platforms`` defaults to the model's device type ('cuda' or
    'cpu').  ``volume_corrected`` is forwarded to the population wrapper's
    ``log_prob``; the other families are always in data units.

    The program's inputs are ``(x[, conditional], probes)``: the trace
    estimator's probes (``()`` for the exact trace) or the symplectic
    family's ``(momentum,)``; :func:`deserialize_log_prob` draws them from
    a seed.
    """
    _check_model(model)
    model = _align_to_target(model, platforms, likelihood=True)
    d, c = _data_dim(model), _cond_dim(model)
    device = _device(model)
    fn = _logprob_closure(model, atol, rtol, method, options, has_cond=c > 0, volume_corrected=volume_corrected)
    spec = _draw_spec(model)
    n = batch if batch is not None else 8  # example rows, symbolized below
    x = torch.zeros((n, d), device=device)
    probes = _draw(spec, x, 0)
    args = (x,) + ((torch.zeros((n, c), device=device),) if c else ()) + (probes,)
    probe_axes = tuple(0 if p.ndim == 2 else 1 for p in probes)
    axes = (0,) + ((0,) if c else ()) + (probe_axes,)
    return _export(fn, args, axes, batch, {"what": "log_prob", "draw": spec}, platforms, device)


def deserialize_log_prob(blob: bytes, *, strict: bool = False) -> Callable[..., torch.Tensor]:
    """Rehydrate an :func:`export_log_prob` artifact into a callable.

    Returns ``f(x[, conditional], seed=0)``: no model object is needed on
    the serving side.  The artifact's provenance stamp (package and torch
    versions, CUDA, commit, target platforms) is checked against the
    serving toolchain: mismatches warn with re-export advice, or refuse
    with ``strict=True``; the stamp is ``.provenance`` on the callable, the
    loaded program ``.program``.
    """
    payload, meta = _strip_provenance(blob, strict)
    if bytes(payload[:8]) == _BUCKET_MAGIC:
        raise ValueError("this blob is a bucketed bundle — use deserialize_log_prob_bucketed")
    program, call = _load(payload)
    if call.get("what") != "log_prob":
        raise ValueError(f"this blob is a {call.get('what')} artifact — use deserialize_sampler")
    module = program.module()

    def f(x, conditional=None, *, seed: int = 0):
        x = torch.as_tensor(x, dtype=torch.float32)
        args = [x]
        if conditional is not None:
            args.append(torch.as_tensor(conditional, dtype=torch.float32, device=x.device))
        args.append(_draw(call["draw"], x, seed))
        return _run(module, *args)

    f.program = program
    f.provenance = meta
    return f


# ---------------------------------------------------------------------------
# artifact provenance (who exported this, with what toolchain)
# ---------------------------------------------------------------------------

_PROV_MAGIC = b"FFTRCP1\n"


def _git_commit() -> Optional[str]:
    """Best-effort commit hash of the exporting checkout (None when the
    package is served from a wheel or outside a git worktree)."""
    try:
        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(__file__)), "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _toolchain() -> dict:
    """The versions a stamp records and a load compares."""
    from .. import __version__

    return {"package": "flowfusion_torch", "package_version": __version__, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _wrap_provenance(payload: bytes, platforms, device_type: str) -> bytes:
    """Prepend a provenance envelope: magic, 4-byte header length, JSON
    header (the toolchain, the exporting commit, the target platforms),
    payload, so that a stale artifact's failure after a toolchain bump is
    diagnosable.  Only the export spawns git: a load compares versions."""
    stamp = {"format": 1, **_toolchain(), "commit": _git_commit(),
             "platforms": sorted({str(p).lower() for p in platforms} if platforms else {device_type})}
    header = json.dumps(stamp).encode()
    return b"".join([_PROV_MAGIC, len(header).to_bytes(4, "big"), header, payload])


def _strip_provenance(blob: bytes, strict: bool):
    """Split ``blob`` into (payload, provenance-or-None) and check the stamp
    against the serving toolchain: a different package version, torch or
    CUDA warns (``torch.export`` programs may still load across versions),
    or refuses under ``strict=True``.  A blob without the envelope (a bare
    saved program) passes through."""
    if bytes(blob[:8]) != _PROV_MAGIC:
        return blob, None
    hlen = int.from_bytes(blob[8:12], "big")
    if len(blob) < 12 + hlen:
        raise ValueError(
            f"corrupt serving artifact: provenance header claims {hlen} "
            f"bytes but only {len(blob) - 12} follow — the blob was "
            "truncated in transit/storage; re-fetch or re-export it"
        )
    try:
        meta = json.loads(blob[12:12 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(
            "corrupt serving artifact: provenance header is not valid "
            f"JSON ({e}) — the blob was damaged; re-fetch or re-export it"
        ) from None
    current = _toolchain()
    mismatches = [
        f"{k}: artifact {meta.get(k)!r} vs serving {current[k]!r}"
        for k in ("package_version", "torch", "cuda")
        if meta.get(k) != current[k]
    ]
    if mismatches:
        msg = (
            "serving artifact was exported under a different toolchain — "
            + "; ".join(mismatches)
            + (f" (exported at commit {meta['commit'][:12]})" if meta.get("commit") else "")
            + ". torch.export programs may still load and serve correctly, "
            "but if calls fail, re-export with the serving toolchain."
        )
        if strict:
            raise ValueError(msg + " (strict=True refuses mismatched artifacts; pass "
                             "strict=False to attempt serving anyway)")
        warnings.warn(msg, stacklevel=3)
    return blob[12 + hlen:], meta


# ---------------------------------------------------------------------------
# batch-bucketed likelihood serving
# ---------------------------------------------------------------------------

_BUCKET_MAGIC = b"FFTRCB1\n"


def export_log_prob_bucketed(model, *, batches: Sequence[int] = (1024, 8192, 65536), **export_kwargs) -> bytes:
    """A ladder of fixed-batch :func:`export_log_prob` artifacts in one
    bundle.  Each bucket is a concrete-batch export; the bundle's
    dispatcher pads each request up to the next bucket, chunking by the
    largest first, so any batch size is servable.  ``export_kwargs`` go to
    :func:`export_log_prob` (tolerances, method, platforms, ...)."""
    bs = sorted(set(int(b) for b in batches))
    if not bs or bs[0] < 1:
        raise ValueError(f"batches must be positive ints, got {batches!r}")
    # the buckets' own envelopes are stripped: the bundle carries one stamp
    blobs = [_strip_provenance(export_log_prob(model, batch=b, **export_kwargs), strict=False)[0] for b in bs]
    header = json.dumps({"batches": bs, "cond": _cond_dim(model) > 0}).encode()
    parts = [_BUCKET_MAGIC, len(header).to_bytes(4, "big"), header]
    for blob in blobs:
        parts.append(len(blob).to_bytes(8, "big"))
        parts.append(blob)
    return _wrap_provenance(b"".join(parts), export_kwargs.get("platforms"), _device(model).type)


def deserialize_log_prob_bucketed(blob: bytes, *, strict: bool = False) -> Callable[..., torch.Tensor]:
    """Rehydrate a bucket bundle into one variable-batch callable.

    ``f(x[, conditional], seed=0)`` accepts any row count: each request is
    padded (with copies of its first row, always-finite solver inputs) up
    to the smallest bucket that fits, oversize requests are chunked by the
    largest bucket, and the padding rows are sliced off the result; each
    chunk draws its probes from ``seed`` at its bucket's size.  The
    bundle's provenance is checked once (warn, or refuse with
    ``strict=True``) and exposed as ``.provenance``.
    """
    blob, prov = _strip_provenance(blob, strict)
    if not bytes(blob[:8]) == _BUCKET_MAGIC:
        raise ValueError(
            "not a bucketed log-prob bundle (bad magic) — use "
            "deserialize_log_prob for single-batch artifacts"
        )
    off = len(_BUCKET_MAGIC)
    hlen = int.from_bytes(blob[off:off + 4], "big")
    off += 4
    meta = json.loads(bytes(blob[off:off + hlen]).decode())
    off += hlen
    fns = {}
    for b in meta["batches"]:
        blen = int.from_bytes(blob[off:off + 8], "big")
        off += 8
        fns[b] = deserialize_log_prob(blob[off:off + blen])
        off += blen
    buckets = sorted(fns)
    biggest = buckets[-1]
    has_cond = meta["cond"]

    def _pad(a, rows):
        return torch.cat([a, a[:1].expand(rows, -1)], dim=0)

    def f(x, conditional=None, *, seed: int = 0):
        x = torch.as_tensor(x, dtype=torch.float32)
        if has_cond and conditional is None:
            raise ValueError("this bundle serves a conditional model — pass `conditional`")
        if conditional is not None:
            if not has_cond:
                raise ValueError(
                    "this bundle serves an unconditional model — `conditional` would be silently ignored"
                )
            conditional = torch.as_tensor(conditional, dtype=torch.float32, device=x.device)
            if conditional.shape[0] != x.shape[0]:
                raise ValueError(
                    f"conditional has {conditional.shape[0]} rows but x has {x.shape[0]} — they must match"
                )
        n = x.shape[0]
        if n == 0:
            return torch.zeros((0,), dtype=torch.float32, device=x.device)
        out, pos = [], 0
        while pos < n:
            take = min(n - pos, biggest)
            bucket = next(b for b in buckets if b >= take)
            xc = x[pos:pos + take]
            cc = conditional[pos:pos + take] if has_cond else None
            if take < bucket:
                xc = _pad(xc, bucket - take)
                if has_cond:
                    cc = _pad(cc, bucket - take)
            lp = fns[bucket](xc, cc, seed=seed) if has_cond else fns[bucket](xc, seed=seed)
            out.append(lp[:take])
            pos += take
        return torch.cat(out)

    f.buckets = tuple(buckets)
    f.provenance = prov
    return f


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def export_sampler(
    model,
    *,
    batch: Optional[int] = None,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    method: str = "dopri5",
    options: Optional[dict] = None,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize ``model``'s deterministic base -> data sampler.

    The program takes standard-normal base noise ``(batch, D)`` —
    ``(batch, 2 D)`` joint (q, p) noise for the symplectic family — plus
    the conditional when the model has one, and returns samples in data
    units.  The noise is an input (not an internal draw), so the artifact
    is deterministic, replayable and batch-polymorphic (``batch=None``).
    Solver tolerances follow each family's sampling defaults unless given;
    the population wrapper pins 1e-5.  The symplectic family is fixed-step:
    ``options={'num_steps': k, 'method': 'euler' | 'leapfrog'}``.
    """
    _check_model(model)
    model = _align_to_target(model, platforms, likelihood=False)
    _, _, _, SymplecticFlowModel = _families()
    d, c = _data_dim(model), _cond_dim(model)
    if isinstance(model, SymplecticFlowModel):
        d = 2 * d
    device = _device(model)
    fn = _sampler_closure(model, atol, rtol, method, options, has_cond=c > 0)
    n = batch if batch is not None else 8
    args = (torch.zeros((n, d), device=device),) + ((torch.zeros((n, c), device=device),) if c else ())
    return _export(fn, args, (0,) * len(args), batch, {"what": "sampler"}, platforms, device)


def deserialize_sampler(blob: bytes, *, strict: bool = False) -> Callable[..., torch.Tensor]:
    """Rehydrate an :func:`export_sampler` artifact: ``f(base[,
    conditional])``.  Provenance as in :func:`deserialize_log_prob`."""
    payload, meta = _strip_provenance(blob, strict)
    if bytes(payload[:8]) == _BUCKET_MAGIC:
        raise ValueError(
            "this blob is a bucketed bundle — use deserialize_log_prob_bucketed "
            "(bucketed exports carry likelihood artifacts, not samplers)"
        )
    program, call = _load(payload)
    if call.get("what") != "sampler":
        raise ValueError(f"this blob is a {call.get('what')} artifact — use deserialize_log_prob")
    module = program.module()

    def f(base, conditional=None):
        base = torch.as_tensor(base, dtype=torch.float32)
        args = [base]
        if conditional is not None:
            args.append(torch.as_tensor(conditional, dtype=torch.float32, device=base.device))
        return _run(module, *args)

    f.program = program
    f.provenance = meta
    return f


def save_artifact(path: str, blob: bytes) -> None:
    """Write a serialized artifact to disk."""
    with open(path, "wb") as f:
        f.write(blob)


def load_artifact(path: str) -> bytes:
    """Read a serialized artifact from disk."""
    with open(path, "rb") as f:
        return f.read()
