"""Load parameters made by the JAX package into the port.

``params_from_jax`` takes the tree that ``burnin.init_params`` (and
``quant.quantize_blocks``) of the JAX package returns — dicts and lists of
arrays, with quantized leaves carrying ``.q``/``.scale`` (int8) or
``.packed``/``.scale``/``.group_size`` (int4) — and returns the port's
params with the same keys and shapes; ``opt_state_from_jax`` does the same
for the optimizer state, and ``adapters_from_jax``/``bank_from_jax`` for
LoRA adapters and serving banks.  Leaves are read through numpy (``np.asarray``),
so nothing of JAX is imported here.  On a mesh, ``shard_params`` and
``unshard_params`` cut the params into a rank's Megatron shards and back;
``pipeline_params``/``dense_params`` turn them into the pipeline layout
(stacked blocks, group-major ``qkv``: the JAX package's pipeline tree
loads through ``params_from_jax`` as it stands) and back, and
``shard_pipeline_params``/``unshard_pipeline_params`` cut that.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.models.burnin import param_leaves, torch_dtype
from k8s_dra_driver_torch.models.quant import Quantized4Matrix, QuantizedMatrix


def tensor_from_array(a, device) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor on ``device``, bf16 kept
    bf16 (numpy stores it as the ``bfloat16`` extension dtype)."""
    a = np.array(a)  # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf(x, device):
    if hasattr(x, "packed"):
        return Quantized4Matrix(
            tensor_from_array(x.packed, device), tensor_from_array(x.scale, device),
            int(x.group_size), torch_dtype(x.dtype),
        )
    if hasattr(x, "q") and hasattr(x, "scale"):
        return QuantizedMatrix(
            tensor_from_array(x.q, device), tensor_from_array(x.scale, device),
            torch_dtype(x.dtype),
        )
    return tensor_from_array(x, device)


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter tree as the port's params on ``device``
    (default the card; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(node, dev)

    return walk(tree)


def adapters_from_jax(tree, device="cuda"):
    """The JAX package's LoRA adapters (``lora.init_adapters``'s tree,
    ``{"blocks": [{target: {"a", "b"}}]}``, float32) as the port's on
    ``device``."""
    return params_from_jax(tree, device)


def bank_from_jax(bank, device="cuda") -> dict:
    """The JAX package's serving bank (``lora.stack_adapters``) as the
    port's on ``device``, its ``scale`` kept a Python float."""
    return {"blocks": params_from_jax(bank["blocks"], device), "scale": float(bank["scale"])}


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax` for float params: the port's
    params tree (dicts and lists of tensors) as numpy arrays on the host,
    bf16 kept bf16 (numpy's ``bfloat16`` extension dtype, which JAX's
    arrays use too).  Reading the arrays waits for the device."""

    def leaf(t):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"params_to_numpy takes tensors, got {type(t).__name__}")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(params)


def _adam_state(node):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (its ``ScaleByAdamState``), or None."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, device="cuda") -> dict:
    """The JAX package's optimizer state (optax's ``adamw`` from
    ``make_optimizer``: its ``ScaleByAdamState``, alone in the ``chain`` or
    after ``clip_by_global_norm``; or the LoRA step's ``adam``, over the
    adapters) as the port's ``AdamW``/``Adam`` state on ``device``:
    ``count`` an int32 0-d tensor, ``mu`` and ``nu`` lists in the order of
    the params' (or adapters') leaves.  The schedule's own count in optax's
    state always equals Adam's, so the one count carries both."""
    adam = _adam_state(state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    dev = resolve_device(device)
    return {
        "count": tensor_from_array(np.asarray(adam.count, dtype=np.int32), dev),
        "mu": param_leaves(params_from_jax(adam.mu, dev)),
        "nu": param_leaves(params_from_jax(adam.nu, dev)),
    }


def groupmajor_qkv(w, cfg):
    """``[D, q(H) | k(Hkv) | v(Hkv)]`` -> ``[D, Hkv x (G·hd q | hd k | hd
    v)]``, the reference's ``pp_burnin._groupmajor_qkv``: a column shard of
    the result holds whole KV groups, G query heads with their KV head."""
    d = w.shape[0]
    h, hkv, hd, g = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.kv_groups
    wq = w[:, : h * hd].reshape(d, hkv, g * hd)
    wk = w[:, h * hd: (h + hkv) * hd].reshape(d, hkv, hd)
    wv = w[:, (h + hkv) * hd:].reshape(d, hkv, hd)
    return torch.cat([wq, wk, wv], dim=2).reshape(d, (h + 2 * hkv) * hd)


def packed_qkv(w, cfg):
    """The inverse of :func:`groupmajor_qkv`."""
    d = w.shape[0]
    h, hkv, hd, g = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.kv_groups
    x = w.reshape(d, hkv, (g + 2) * hd)
    parts = (x[..., : g * hd], x[..., g * hd: (g + 1) * hd], x[..., (g + 1) * hd:])
    return torch.cat([p.reshape(d, -1) for p in parts], dim=1)


def _leaf_specs(specs, key=None) -> list:
    """``[(key, spec)]`` of a spec tree in the params' leaf order."""
    from k8s_dra_driver_torch.parallel.mesh import PartitionSpec

    if isinstance(specs, PartitionSpec):
        return [(key, specs)]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _leaf_specs(specs[k], k)]
    return [x for s in specs for x in _leaf_specs(s, key)]


def _relayout(cfg, params, opt_state, leaf_fn, spec_tree=None):
    """``params`` and ``opt_state`` (None, or an AdamW state over them) with
    each float leaf ``t`` replaced by ``leaf_fn(t, key, spec)``; the specs
    ``spec_tree``'s (default ``burnin.param_pspecs``)."""
    from k8s_dra_driver_torch.models.burnin import _unflatten, param_pspecs

    specs = _leaf_specs(param_pspecs(cfg) if spec_tree is None else spec_tree)
    leaves = param_leaves(params)
    if len(leaves) != len(specs):
        raise ValueError(f"params have {len(leaves)} leaves, the config's layout {len(specs)}")

    def each(ts):
        return [leaf_fn(t, key, spec) for t, (key, spec) in zip(ts, specs)]

    out = _unflatten(params, iter(each(leaves)))
    if opt_state is None:
        return out, None
    return out, {"count": opt_state["count"].clone(), "mu": each(opt_state["mu"]),
                 "nu": each(opt_state["nu"])}


def shard_params(cfg, mesh, params, opt_state=None):
    """Full params (and an AdamW state over them, or None) -> this rank's
    shards under ``burnin.param_pspecs``: ``(params, opt_state)``.  ``qkv``
    (and its moments) is reordered group-major before its columns are cut,
    so a model shard holds whole KV groups; every shard is a new contiguous
    tensor on the params' device."""
    from k8s_dra_driver_torch.parallel.mesh import shard

    def leaf(t, key, spec):
        if key == "qkv":
            t = groupmajor_qkv(t, cfg)
        return shard(t, mesh, spec).clone()

    return _relayout(cfg, params, opt_state, leaf)


def unshard_params(cfg, mesh, params, opt_state=None):
    """The inverse of :func:`shard_params` on every rank: each shard
    all-gathered over its spec's axes, ``qkv`` put back in the packed
    layout."""
    from k8s_dra_driver_torch.parallel.mesh import gather

    def leaf(t, key, spec):
        t = gather(t, mesh, spec)
        return packed_qkv(t, cfg) if key == "qkv" else t

    return _relayout(cfg, params, opt_state, leaf)


def pipeline_params(cfg, params) -> dict:
    """Dense params (``burnin.init_params``'s layout) -> the pipeline
    layout of the reference's ``pp_burnin.pp_params_from_dense``: the
    blocks stacked, ``{leaf: [L, ...]}``, ``qkv`` group-major; ``embed``,
    ``ln_f`` and (without RoPE) ``pos_embed`` as they are.  The JAX
    package's pipeline tree loads through :func:`params_from_jax` as it
    stands."""
    from k8s_dra_driver_torch.ops.pipeline import stack_blocks

    blocks = [{**blk, "qkv": groupmajor_qkv(blk["qkv"], cfg)} for blk in params["blocks"]]
    out = {"embed": params["embed"], "ln_f": params["ln_f"], "blocks": stack_blocks(blocks)}
    if not cfg.rope:
        out["pos_embed"] = params["pos_embed"]
    return out


def dense_params(cfg, pipeline) -> dict:
    """The inverse of :func:`pipeline_params`: the stacked blocks as a
    list, ``qkv`` packed again."""
    stacked = pipeline["blocks"]
    blocks = [{k: v[i] for k, v in stacked.items()} for i in range(stacked["qkv"].shape[0])]
    for blk in blocks:
        blk["qkv"] = packed_qkv(blk["qkv"], cfg)
    out = {k: v for k, v in pipeline.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def shard_pipeline_params(cfg, mesh, params, opt_state=None):
    """Pipeline-layout params (and an AdamW state over them, or None) ->
    this rank's shards under ``pp_burnin.pp_param_pspecs``: its stage's
    blocks (leading dim over ``pipe``), their Megatron columns or rows
    over ``model``, its vocab rows of ``embed``; new contiguous tensors."""
    from k8s_dra_driver_torch.models.pp_burnin import pp_param_pspecs
    from k8s_dra_driver_torch.parallel.mesh import shard

    return _relayout(cfg, params, opt_state,
                     lambda t, key, spec: shard(t, mesh, spec).clone(), pp_param_pspecs(cfg))


def unshard_pipeline_params(cfg, mesh, params, opt_state=None):
    """The inverse of :func:`shard_pipeline_params` on every rank, by
    all-gathers."""
    from k8s_dra_driver_torch.models.pp_burnin import pp_param_pspecs
    from k8s_dra_driver_torch.parallel.mesh import gather

    return _relayout(cfg, params, opt_state,
                     lambda t, key, spec: gather(t, mesh, spec), pp_param_pspecs(cfg))
