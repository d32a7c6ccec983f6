"""Rank bodies of ``tests/test_torch_distributed.py``.

Each runs in a process that ``repro_torch.launch.mesh.spawn`` starts, on
one intra-op thread, and imports only ``repro_torch`` (never ``jax`` or
``repro``): the JAX results are computed in the test process.  Each
returns plain values and CPU tensors.
"""

import dataclasses

import torch


def _smoke_cfg(profile, rns_targets="mlp", **rns_kw):
    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig

    cfg = get_config("smollm-135m", smoke=True)
    if profile is None:
        return cfg
    return dataclasses.replace(
        cfg, rns=RnsDotConfig(profile=profile, **rns_kw),
        rns_targets=rns_targets)


def _model(cfg, weights: str):
    from repro_torch.models import model as M

    model = M.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(torch.load(weights))
    return model


def _chain(x, ws):
    from repro_torch.core.tensor import rt_decode, rt_encode, rt_matmul

    ht = rt_encode(x, "rns16", bits=8)
    for w in ws:
        ht = rt_matmul(ht, rt_encode(w, "rns16", bits=8))
    return rt_decode(ht)


def _residue_segment(x, ws):
    from repro_torch.core.tensor import rt_encode, rt_matmul, rt_mul

    ht = rt_encode(x, "rns16", bits=8)
    for w in ws:
        ht = rt_matmul(ht, rt_encode(w, "rns16", bits=8))
    return rt_mul(ht, rt_encode(x, "rns16", bits=8)).digits


def chain_and_serve(rank, n, inputs):
    """On a (1, n) mesh: the rns16 chain, its residue segment, the
    placement helpers, the capture refusal and ContinuousEngine per-op,
    resident and without masters; on a (2, n/2) mesh and an (n, 1) mesh:
    DP x digit and float DP training steps."""
    from repro_torch.core import dispatch
    from repro_torch.core.tensor import (rt_decode, rt_device_put,
                                         rt_digit_sharding, rt_encode,
                                         rt_matmul)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_digit_mesh
    from repro_torch.models.resident import encode_resident
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    torch.set_num_threads(1)
    out = {}
    mesh = make_digit_mesh(n)
    out["rules"] = {
        "spec": SH.spec_for_axes(("embed", "mlp", "vocab"), (64, 256, 49152),
                                 mesh),
        "batch": SH.batch_spec(mesh), "dp_size": SH.dp_size(mesh),
        "first": SH.first_valid_spec((4, 8), [("data", "model"),
                                              ("data", None)], mesh)}
    x = torch.from_numpy(inputs["x"])
    ws = [torch.from_numpy(w) for w in inputs["ws"]]

    out["unsharded_chain"] = _chain(x, ws)
    whole_ws = [rt_encode(w, "rns16", bits=8) for w in ws]
    with SH.use_digit_sharding(mesh):
        # weights encoded off the context: each matmul takes its rank's
        # group of the whole [16, ...] planes, as GSPMD reshards them
        ht = rt_encode(x, "rns16", bits=8)
        for w in whole_ws:
            ht = rt_matmul(ht, w)
        out["whole_operand_chain"] = rt_decode(ht)
        SH.reset_collective_counts()
        with dispatch.count_ops() as ops:
            out["sharded_chain"] = _chain(x, ws)
        out["chain_collectives"] = SH.collective_counts()
        out["chain_ops"] = ops.as_dict()
        SH.reset_collective_counts()
        seg = _residue_segment(x, ws)
        out["segment_collectives"] = SH.collective_counts()
        out["segment_digits"] = seg
    full = rt_encode(ws[0], "rns16", bits=8)       # whole: [16, 64, 64]
    with SH.use_digit_sharding(mesh):
        out["spec"] = rt_digit_sharding(full)
        out["spec_p"] = rt_digit_sharding(
            dataclasses.replace(full, digits=full.digits[None]),
            digit_axis=1)
        put = rt_device_put(full)
        out["put"] = put.digits
        out["put_again_same"] = rt_device_put(put) is put
    out["full_digits"] = full.digits
    out["no_ctx_put_same"] = rt_device_put(full) is full

    # the serving engine on the smoke twin
    cfg = _smoke_cfg(inputs["serve_profile"], qx=8, qw=8)
    kw = dict(max_cache=48, max_new_tokens=5, page_size=16, max_seqs=2)
    prompts = inputs["prompts"]
    try:
        ContinuousEngine(_model(cfg, inputs["serve_weights"]),
                         ServeConfig(mesh=mesh, **kw), device="cuda",
                         graphs=True)
        out["capture_refusal"] = None
    except ValueError as e:
        out["capture_refusal"] = str(e)
    for name, over in (("perop", {}), ("resident",
                                       {"resident_weights": True})):
        eng = ContinuousEngine(_model(cfg, inputs["serve_weights"]),
                               ServeConfig(mesh=mesh, **kw, **over),
                               device="cpu")
        SH.reset_collective_counts()
        with dispatch.count_ops() as ops:
            res, stats = eng.run(prompts)
        out[f"serve_{name}"] = {k: v.tolist() for k, v in res.items()}
        out[f"serve_{name}_gathers"] = SH.collective_counts()
        out[f"serve_{name}_normalizes"] = ops.normalizes
        out[f"serve_{name}_backend"] = stats["collective_backend"]
        if name == "resident":
            mlp = eng.model.blocks[0].mlp
            out["resident_shape"] = tuple(mlp.resident("wi").digits.shape)
    model = _model(cfg, inputs["serve_weights"])
    encode_resident(model, cfg, drop_masters=True, mesh=mesh)
    mlp = model.blocks[0].mlp
    out["dropped"] = (mlp.wi is None, mlp.wg is None, mlp.wo is None,
                      tuple(mlp.resident("wo").digits.shape))
    res, _ = ContinuousEngine(model, ServeConfig(mesh=mesh, **kw),
                              device="cpu").run(prompts)
    out["serve_dropped"] = {k: v.tolist() for k, v in res.items()}

    # data parallel x digit training, and float data parallelism
    for name, shape, profile in (("dp_rns", (2, n // 2), "rns8"),
                                 ("dp_float", (n, 1), None)):
        out[name] = _dp_steps(shape, profile, inputs)
    return out


def _dp_steps(shape, profile, inputs):
    from repro_torch.core import dispatch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_digit_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    mesh = make_digit_mesh(shape[1], n_data=shape[0])
    cfg = _smoke_cfg(profile, qx=8, qw=8)
    key = "train_weights_rns" if profile else "train_weights_float"
    model = _model(cfg, inputs[key]).requires_grad_(True)
    state = {"model": model,
             "opt": adamw.init_opt_state(dict(model.named_parameters()))}
    step = ts.make_dp_train_step(cfg, adamw.AdamWConfig(**inputs["adam"]),
                                 mesh)
    losses, norms, counts, normalizes = [], [], [], []
    for toks in inputs["batches"]:
        SH.reset_collective_counts()
        with dispatch.count_ops() as ops:
            _, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        counts.append(SH.collective_counts())
        normalizes.append(ops.normalizes)
    return {"losses": losses, "grad_norms": norms, "collectives": counts,
            "normalizes": normalizes,
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()}}


def raises(rank, n):
    """Rank 1 raises at once; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.ones(4)
    dist.all_reduce(t)
    return float(t.sum())


def sleeps(rank, n, seconds):
    import time

    time.sleep(seconds)
    return rank
