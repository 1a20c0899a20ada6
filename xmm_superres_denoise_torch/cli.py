"""Command line of the PyTorch port.

    python -m xmm_superres_denoise_torch.cli fit  <run_config.toml> [--no-extended]
    python -m xmm_superres_denoise_torch.cli test <run_config.toml> [--no-extended]
    python -m xmm_superres_denoise_torch.cli infer --fits F --checkpoint C --out DIR --run_config R
    python -m xmm_superres_denoise_torch.cli serve 'DIR/*.fits' --checkpoint C --out DIR --run_config R
    python -m xmm_superres_denoise_torch.cli serve DIR --watch ... (a polling daemon)
    python -m xmm_superres_denoise_torch.cli http --checkpoint C --run_config R [--port N]
    python -m xmm_superres_denoise_torch.cli detxy --pps DIR --out DIR
    python -m xmm_superres_denoise_torch.cli end2end --pps DIR --checkpoint C --out DIR --run_config R
    python -m xmm_superres_denoise_torch.cli export --checkpoint FIT_DIR --out W.onnx|W.npz --run_config R
    python -m xmm_superres_denoise_torch.cli verify --onnx W.onnx --run_config R --data DIR

The port of the JAX package's `cli.py` subcommands, with the same flags,
the same JSON on standard output and the same run-config assembly
(`load_run_config`). Every model of the registry is served and trained: the
RRDB generators and the transformer zoo (SwinIR, SwinFIR, DRCT, HAT,
Restormer), each from its run config. The model runs on `--device`,
`cuda:0` unless the caller asks for the CPU; without a card, a run that
does not pass `--device cpu` fails. `detxy` and `export` run on the host
(the event binning of the obsid chain is the host route, as in the JAX
package).

A serving checkpoint (`--checkpoint` of `infer`, `serve`, `http` and
`end2end`) is an npz in the Flax layout, an ONNX file (its initializers,
torch-named, as the reference ships them and `export` writes them) or the
directory a port `fit` wrote (its best checkpoint). `export` writes a fit
directory's best weights as npz, or as ONNX: the full runnable graph for the
RRDB models, the torch-named initializers for the others. `verify` holds an
ONNX checkpoint's graph, run by an independent runtime, against the port's
forward on FITS images, and the int8 forward against f32.

`fit` trains from the run config (`train/loop.py: Trainer`), then tests the
best checkpoint as `test` does and prints the test metrics as strict JSON
(null for an undefined metric); `test` only restores and tests. Under `torchrun` (one
process per card) `fit` and `test` run data parallel: DDP, or FSDP2 when
`trainer.mesh.fsdp` > 1; each process takes `cuda:<LOCAL_RANK>`.
`--int8_scales` binds the calibrated int8 scales to the checkpoint with
`utils/fingerprint.py`, whose digest is the JAX package's: one scales file
serves both packages.

`--mesh_data N` serves each batch over a data axis of N local cards from
this one process (`parallel/mesh.py: serving_devices`; -1 takes every card,
0 or 1 one card; with `--device cpu`, N replicas on the host), as the JAX
package's `--mesh_data` does. `--plot` adds the products' PNGs (it needs
matplotlib). `fit --profile DIR` writes a torch.profiler trace of the fit
into DIR (`utils/profiling.py: trace`), from the fit's start to the end of
its first `FIT_PROFILE_STEPS` train steps (JAX's `--profile` traces the
whole fit): torch.profiler holds every event in host memory until it writes
the trace, and one train step of the shipped RRDB config makes hundreds of
thousands.

Refused with exit code 2 and a message: orbax checkpoint directories of the
JAX package (they need JAX; its `export` writes them as npz or ONNX), a
`--mesh_data` asking for more cards than are visible, and `--plot` without
matplotlib.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import logging
import signal
import threading
import tomllib
from pathlib import Path

import torch

from .config.schema import RES_DIR, TrainerCfg
from .config.schema import load_run_config as load_dataset_and_model

log = logging.getLogger("xmmsr")

# the train steps `fit --profile` traces
FIT_PROFILE_STEPS = 3


class CliError(Exception):
    """A refused request: `main` logs the message and returns 2."""


def load_run_config(path: Path, res_dir: Path = RES_DIR):
    """Run TOML -> (DatasetCfg, ModelCfg, TrainerCfg, loss sc_dict, LossCfg),
    as the JAX package's `cli.load_run_config` assembles them: the model from
    the registry, the loss weights and the stretch's scaling table from
    `loss_functions.toml`, and `memory_efficient` forced on by `mesh.remat`."""
    from .train.loss import load_scaling_tables

    dataset_config, model_config = load_dataset_and_model(path, res_dir)
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    with open(Path(res_dir) / "configs" / "loss_functions.toml", "rb") as f:
        loss_toml = tomllib.load(f)
    sc_dict, loss_config = load_scaling_tables(loss_toml, dataset_config.scaling)
    trainer_config = TrainerCfg(**cfg.get("trainer", {}))
    if trainer_config.mesh.remat and not model_config.memory_efficient:
        model_config = dataclasses.replace(model_config, memory_efficient=True)
    return dataset_config, model_config, trainer_config, sc_dict, loss_config


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(
            f"--device {args.device}: no CUDA card is visible; pass --device cpu "
            "to run on the CPU"
        )
    return device


def _build_trainer(args):
    """Run config -> data module, loss and `Trainer` on `--device` (or, in a
    torchrun process group, on this process's card). Returns (trainer,
    trainer config)."""
    from .data.datamodule import XmmDataModule
    from .ops.stretch import Normalizer
    from .parallel.distributed import initialize_distributed
    from .train.loop import Trainer
    from .train.loss import create_loss

    device = _device(args)
    local_rank = initialize_distributed(device.type)
    if local_rank is not None and device.type == "cuda":
        device = torch.device("cuda", local_rank)
    ds_cfg, m_cfg, t_cfg, sc_dict, l_cfg = load_run_config(args.run_config)
    dm = XmmDataModule(ds_cfg, seed=t_cfg.seed, boring_size=ds_cfg.boring_size, device=device)
    scaling_normalizers = [
        Normalizer(
            lr_max=ds_cfg.lr.clamp_max,
            hr_max=ds_cfg.hr.clamp_max if ds_cfg.hr else ds_cfg.lr.clamp_max,
            mode="linear",
        )
    ]
    try:
        trainer = Trainer(m_cfg, t_cfg, dm, create_loss(sc_dict, l_cfg), scaling_normalizers,
                          device=device)
    except (NotImplementedError, RuntimeError, ValueError) as e:  # what the trainer refuses
        raise CliError(str(e)) from e
    return trainer, t_cfg


def _snapshot_run_config(trainer, run_config: Path) -> None:
    """Copy the run config next to the checkpoints, so a checkpoint
    directory records which TOML produced it. A resume with an edited
    config keeps the original and adds the edit as `run_config.<n>.toml`,
    once."""
    import shutil

    dst = trainer.ckpt.root / "run_config.toml"
    try:
        src_bytes = Path(run_config).read_bytes()
        if dst.exists() and dst.read_bytes() != src_bytes:
            n = 1
            while True:
                sidecar = trainer.ckpt.root / f"run_config.{n}.toml"
                if not sidecar.exists():
                    break
                if sidecar.read_bytes() == src_bytes:
                    return  # this exact config is already on record
                n += 1
            dst = sidecar
        if not dst.exists():
            shutil.copyfile(run_config, dst)
    except OSError as e:  # snapshotting must never block a fit
        log.warning("run-config snapshot failed: %s", e)


def _print_logs_json(logs) -> None:
    """Strict JSON: an undefined metric (an empty test split, say) is
    written as null, not as the non-standard NaN token."""
    import math

    clean = {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
             for k, v in logs.items()}
    print(json.dumps(clean, indent=2))


def cmd_fit(args) -> int:
    from .parallel.distributed import is_primary

    trainer, t_cfg = _build_trainer(args)
    if is_primary():
        _snapshot_run_config(trainer, args.run_config)
    ctx = contextlib.nullcontext()
    if args.profile is not None:  # a trace of the fit's first train steps
        from .utils.profiling import trace

        ctx = trace(args.profile, steps=FIT_PROFILE_STEPS)
    with ctx as step:
        trainer.step_callback = step
        result = trainer.fit(seed=t_cfg.seed, resume=t_cfg.checkpoint_path is not None)
    log.info("fit done: best val/loss %.5f at epoch %d", result.best_val_loss, result.best_step)
    # test as `test` does, from a fresh data module: a composite dataset
    # draws its AGN and background files from one generator in sample order,
    # so after the fit's train and val passes the test split would hold
    # other composites than a later `test` of the same checkpoint sees
    return cmd_test(args)


def cmd_test(args) -> int:
    from .parallel.distributed import is_primary

    trainer, _ = _build_trainer(args)
    logs = trainer.test(extended=not args.no_extended)
    if is_primary():
        _print_logs_json(logs)
    return 0


def _check_plot(args) -> None:
    """`--plot` draws with matplotlib: without it, refuse before serving
    rather than fail after the first products."""
    if getattr(args, "plot", False):
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise CliError(f"--plot needs matplotlib ({e}); the FITS products need none") from e


def _serving_mesh(args, device: torch.device):
    """`--mesh_data` -> the engine's mesh: None for one device (0 or 1),
    else the data axis of `serving_devices`."""
    from .parallel.mesh import serving_devices

    n = int(getattr(args, "mesh_data", 0) or 0)
    if n in (0, 1):
        return None
    try:
        mesh = serving_devices(n, device.type)
    except ValueError as e:
        raise CliError(f"--mesh_data {n}: {e}") from e
    log.info("serving mesh: %s", {"data": len(mesh), "devices": [str(d) for d in mesh]})
    return mesh


def _is_fit_dir(path: Path) -> bool:
    """A checkpoint directory the port's `fit` wrote (`train/checkpoints.py`)."""
    return (path / "best.json").exists() or (path / "ckpts" / "index.json").exists()


def _fit_dir_weights(ckpt: Path, model):
    """The best checkpoint of a port fit directory -> (the model's Flax
    arrays, flat and '/'-keyed, in the model's layout; the checkpoint's step)."""
    from .infer.onnx_import import flatten_tree
    from .train.checkpoints import CheckpointManager
    from .utils.weights import flax_tree

    state, step = CheckpointManager(ckpt).best_model_state()
    model.load_state_dict(state)
    tree = flax_tree(model.state_dict(), scan_layers=getattr(model, "scan_layers", False))
    return dict(flatten_tree(tree)), step


def _load_checkpoint(ckpt: Path, model):
    """A serving checkpoint -> the model's Flax arrays, flat and '/'-keyed
    without the `params` root: an npz in the Flax layout, an ONNX file, or a
    port fit directory (its best checkpoint)."""
    from .infer.onnx_import import flatten_tree, import_onnx_params
    from .utils.weights import flax_tree, load_params_npz

    if ckpt.is_dir():
        if _is_fit_dir(ckpt):
            return _fit_dir_weights(ckpt, model)[0]
        raise CliError(
            f"--checkpoint {ckpt}: not a directory the port's `fit` wrote (an orbax "
            "checkpoint directory needs JAX; export it with the JAX package's "
            "`cli.py export --out weights.npz` or `--out weights.onnx`)"
        )
    if not ckpt.exists():
        raise CliError(f"--checkpoint {ckpt}: no such file")
    if ckpt.suffix == ".onnx":
        template = flax_tree(model.state_dict(), scan_layers=getattr(model, "scan_layers", False))
        try:
            return dict(flatten_tree(import_onnx_params(ckpt, template)))
        except ValueError as e:  # unmatched or ambiguous initializers
            raise CliError(f"--checkpoint {ckpt}: {e}") from e
    if ckpt.suffix != ".npz":
        raise CliError(f"--checkpoint {ckpt}: expected an .npz or .onnx file or a fit directory")
    return load_params_npz(ckpt, model)


def _load_scales(path, fingerprint: str):
    """The int8 scales a `--int8_scales` file holds for this checkpoint, or
    None when there is none to use (no file, or one bound to another
    checkpoint: the engine then calibrates on its first batch)."""
    if not path or not Path(path).exists():
        return None
    obj = json.loads(Path(path).read_text())
    if isinstance(obj, dict) and "scales" in obj:
        if obj.get("fingerprint") == fingerprint:
            return obj["scales"]
        log.warning(
            "int8 scales %s were calibrated for a DIFFERENT checkpoint "
            "(fingerprint mismatch); ignoring them and recalibrating from the "
            "first batch.", path,
        )
        return None
    log.warning(
        "int8 scales %s carry no checkpoint fingerprint (legacy format); using "
        "as-is. Re-save to bind them to this checkpoint.", path,
    )
    return obj


def _build_engine(args):
    """Run config -> model -> npz params -> optional fingerprint-bound int8
    scales -> InferenceEngine on `--device`.

    Returns (engine, ds_cfg, m_cfg, save_scales): `save_scales()` writes the
    scales calibrated on the first batch, with the checkpoint's fingerprint,
    when an `--int8_scales` path was given and no valid scales were loaded."""
    from .data.datasets import load_det_mask
    from .infer.run_file import InferenceEngine
    from .models.registry import build_model
    from .utils.fingerprint import params_fingerprint
    from .utils.weights import flax_tree, params_from_flax

    _check_plot(args)
    device = _device(args)
    mesh = _serving_mesh(args, device)
    ds_cfg, m_cfg, _, _, _ = load_run_config(args.run_config)
    lr = (ds_cfg.lr.res, ds_cfg.lr.res)
    hr = (ds_cfg.hr.res, ds_cfg.hr.res) if ds_cfg.hr else lr
    model = build_model(m_cfg, lr, hr)
    flat = _load_checkpoint(Path(args.checkpoint), model)
    fingerprint = params_fingerprint({"params": flax_tree(flat)})

    mask = load_det_mask(ds_cfg.lr.det_mask) if ds_cfg.lr.det_mask else None
    scales_path = getattr(args, "int8_scales", None)
    scales = _load_scales(scales_path, fingerprint) if args.int8 else None
    try:
        engine = InferenceEngine(
            m_cfg, ds_cfg, params_from_flax(flat, model), det_mask=mask,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            crop_p=getattr(args, "crop_p", 1.0), quantize=args.int8,
            int8_scales=scales, mesh=mesh, device=device,
        )
    except ValueError as e:  # what the engine refuses (int8 of a transformer, say)
        raise CliError(str(e)) from e

    def save_scales() -> None:
        if args.int8 and scales_path and scales is None and engine.int8_scales:
            Path(scales_path).write_text(json.dumps({
                "fingerprint": fingerprint,
                "scales": engine.int8_scales,
            }))

    return engine, ds_cfg, m_cfg, save_scales


def _hr_exp_ks(ds_cfg) -> float:
    return float(ds_cfg.hr.exp if ds_cfg.hr else ds_cfg.lr.exps[0])


def cmd_infer(args) -> int:
    from .infer.run_file import infer_file

    engine, ds_cfg, m_cfg, save_scales = _build_engine(args)
    p_in, p_pred = infer_file(
        Path(args.fits), engine, Path(args.out),
        hr_exp_ks=_hr_exp_ks(ds_cfg), model_name=m_cfg.name.value, plot=args.plot,
    )
    save_scales()
    print(json.dumps({"input": str(p_in), "prediction": str(p_pred)}))
    return 0


def cmd_serve(args) -> int:
    """Batched serving: detxy FITS files (paths or glob patterns, each file
    once) through one warm engine -> product pairs. With --watch the
    positional arguments are directories polled as a daemon."""
    from .infer.run_file import serve_files, watch_and_serve

    if args.watch:
        dirs = [Path(p) for p in args.fits]
        missing = [str(d) for d in dirs if not d.is_dir()]
        if missing:
            log.error("serve --watch: not directories: %s", missing)
            return 2
        engine, ds_cfg, m_cfg, save_scales = _build_engine(args)
        stop = threading.Event()
        prev = _install_stop_signals(stop)
        log.info("serve --watch: polling %s every %.1fs (SIGTERM stops)",
                 [str(d) for d in dirs], args.poll)
        try:
            n = watch_and_serve(
                dirs, engine, Path(args.out),
                hr_exp_ks=_hr_exp_ks(ds_cfg), model_name=m_cfg.name.value,
                batch_size=args.batch, poll_s=args.poll, state_path=args.state,
                stop=stop, max_polls=args.max_polls, plot=args.plot,
            )
        finally:  # in-process callers keep their handlers
            _restore_stop_signals(prev)
        save_scales()
        print(json.dumps({"served": n}))
        return 0

    files: list = []
    unmatched: list = []
    for pat in args.fits:
        hits = sorted(glob.glob(str(pat)))
        if hits:
            files.extend(hits)
        elif Path(pat).exists():  # a literal path holding glob metacharacters
            files.append(pat)
        else:
            unmatched.append(str(pat))
    if unmatched or not files:
        log.error("serve: no input files matched %s", unmatched or args.fits)
        return 2
    files = list(dict.fromkeys(files))  # overlapping patterns: serve once
    engine, ds_cfg, m_cfg, save_scales = _build_engine(args)
    results = serve_files(
        files, engine, Path(args.out),
        hr_exp_ks=_hr_exp_ks(ds_cfg), model_name=m_cfg.name.value,
        batch_size=args.batch, plot=args.plot,
    )
    save_scales()
    print(json.dumps([
        {"file": str(f), "input": str(p[0]), "prediction": str(p[1])}
        for f, p in zip(files, results)
    ]))
    return 0


def cmd_http(args) -> int:
    """HTTP inference service over one warm engine (infer/http_server.py);
    SIGTERM and SIGINT stop it cleanly."""
    from .infer.http_server import run_http_server

    engine, ds_cfg, m_cfg, save_scales = _build_engine(args)
    stop = threading.Event()
    prev = _install_stop_signals(stop)
    try:
        server = run_http_server(
            args.host, args.port, engine,
            hr_exp_ks=_hr_exp_ks(ds_cfg), model_name=m_cfg.name.value, stop=stop,
        )
    finally:
        _restore_stop_signals(prev)
    save_scales()
    print(json.dumps({"served": server.stats()}))
    return 0


def _install_stop_signals(stop: threading.Event) -> dict:
    """SIGTERM/SIGINT -> stop.set(); returns the previous handlers. Only the
    main thread can install handlers: elsewhere (tests or a notebook calling
    `main()` in a worker thread) this does nothing and the caller stops the
    daemon through the event."""
    prev = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[s] = signal.signal(s, lambda *_: stop.set())
        except ValueError:  # not the main thread
            pass
    return prev


def _restore_stop_signals(prev: dict) -> None:
    for s, h in prev.items():
        try:
            signal.signal(s, h)
        except ValueError:
            pass


def cmd_end2end(args) -> int:
    """obsid PPS dir -> detxy -> SR/DN products (the reference's
    inference_end2end_obsid.py), through the serving engine of `infer`."""
    from .infer.end2end import run_end2end

    engine, ds_cfg, m_cfg, save_scales = _build_engine(args)
    result = run_end2end(
        Path(args.pps), engine, Path(args.out),
        hr_exp_ks=_hr_exp_ks(ds_cfg), model_name=m_cfg.name.value,
        instrument=args.instrument, max_expo_ks=args.max_expo, use_sas=args.use_sas,
        plot=args.plot,
    )
    save_scales()
    print(json.dumps({k: str(v) for k, v in result.items()}))
    return 0


def cmd_detxy(args) -> int:
    """PPS dir -> detxy image FITS (and its radec companion), on the host."""
    from .infer.end2end import detxy_for_obsid

    out = detxy_for_obsid(
        Path(args.pps), Path(args.out), instrument=args.instrument,
        max_expo_ks=args.max_expo, use_sas=args.use_sas,
    )
    print(json.dumps({"detxy": str(out)}))
    return 0


def cmd_export(args) -> int:
    """The best checkpoint of a port fit directory -> the deployment
    formats: ONNX (the full runnable graph for the RRDB models, torch-named
    initializers for the others) or a Flax-layout npz."""
    from .models.registry import build_model
    from .models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
    from .utils.weights import save_params_npz

    ckpt = Path(args.checkpoint)
    if not (ckpt.is_dir() and _is_fit_dir(ckpt)):
        raise CliError(
            f"--checkpoint {ckpt}: expected the checkpoint directory a port `fit` wrote "
            "(<checkpoint_root>/<model>; an orbax directory of the JAX package needs JAX)"
        )
    ds_cfg, m_cfg, _, _, _ = load_run_config(args.run_config)
    lr = (ds_cfg.lr.res, ds_cfg.lr.res)
    hr = (ds_cfg.hr.res, ds_cfg.hr.res) if ds_cfg.hr else lr
    model = build_model(m_cfg, lr, hr)
    _, step = _fit_dir_weights(ckpt, model)  # loads the best weights into `model`
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.suffix == ".onnx":
        if isinstance(model, (GeneratorRRDB_SR, GeneratorRRDB_DN)):
            from .infer.onnx_export import export_rrdb_onnx_model

            export_rrdb_onnx_model(model, None, out)
        else:
            from .infer.onnx_import import export_onnx_params

            export_onnx_params(model, out)
    else:
        save_params_npz(out, model)
    print(json.dumps({"exported": str(out), "from_step": int(step)}))
    return 0


def cmd_verify(args) -> int:
    """The real-weights parity gate (infer/verify.py): ONNX import, the
    graph on an independent runtime vs the port's forward (pixel <= tol),
    PSNR/SSIM per file, the int8 gate. Exit code 0 iff every gate passes."""
    from .infer.verify import default_example_files, verify_onnx

    device = _device(args)
    ds_cfg, m_cfg, _, _, _ = load_run_config(args.run_config)
    if args.data is not None:
        files = sorted(Path(args.data).glob("*.fits*"))
        if args.limit:
            files = files[: args.limit]
    else:
        files = default_example_files(limit=args.limit)
    if not files:
        print(json.dumps({"error": "no input FITS files found"}))
        return 2
    report = verify_onnx(Path(args.onnx), ds_cfg, m_cfg, files, tol=args.tol,
                         int8=not args.no_int8, device=device)
    print(json.dumps(report, indent=2))
    return 0 if report["passed"] else 1


def _engine_flags(p: argparse.ArgumentParser) -> None:
    """The flags of every subcommand that builds an engine."""
    p.add_argument("--checkpoint", type=Path, required=True,
                   help="npz checkpoint in the Flax layout, ONNX file, or the "
                        "directory a port `fit` wrote")
    p.add_argument("--run_config", type=Path, required=True)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 serving mode (f32 is the parity mode)")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 quantized serving (the RRDB models only; scales calibrated "
                        "on the first batch)")
    p.add_argument("--int8_scales", type=Path, default=None,
                   help="calibrated-scales JSON bound to the checkpoint: loaded "
                        "if it exists and matches, written after the first "
                        "batch's calibration otherwise")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="shard serving batches over a data axis of N local cards "
                        "(0 = one device, -1 = every card; with --device cpu, N "
                        "replicas on the host)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device to serve on (default cuda:0; cpu runs "
                        "the kernels' plain versions)")


def build_parser() -> argparse.ArgumentParser:
    """The command line (testable without dispatch)."""
    parser = argparse.ArgumentParser(prog="xmmsr-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("fit", "test"):
        p = sub.add_parser(name, help=f"{name} a model from a run config")
        p.add_argument("run_config", type=Path)
        p.add_argument("--no-extended", action="store_true",
                       help="test without the extended metric suite")
        if name == "fit":
            p.add_argument("--profile", type=Path, default=None,
                           help="write a torch.profiler trace of the fit into this "
                                "directory, from its start to the end of its first "
                                f"{FIT_PROFILE_STEPS} train steps (the profiler holds every "
                                "event in host memory)")
        p.add_argument("--device", default="cuda:0",
                       help="torch device (default cuda:0; cpu runs the kernels' plain "
                            "versions; under torchrun each process takes cuda:<LOCAL_RANK>)")
        p.set_defaults(func=cmd_fit if name == "fit" else cmd_test)

    p = sub.add_parser("infer", help="run SR/DN inference on a detxy FITS")
    p.add_argument("--fits", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--plot", action="store_true",
                   help="also write PNG plots of the products (needs matplotlib)")
    p.add_argument("--crop_p", type=float, default=1.0,
                   help="crop fraction applied after padding, origin per the "
                        "dataset crop_mode (1.0 = no crop)")
    _engine_flags(p)
    p.set_defaults(func=cmd_infer)

    p = sub.add_parser("serve", help="batched serving: many detxy FITS through "
                                     "one warm engine")
    p.add_argument("fits", nargs="+", help="detxy FITS paths or glob patterns")
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--batch", type=int, default=32, help="device batch size")
    p.add_argument("--plot", action="store_true",
                   help="also write PNG plots of the products (needs matplotlib)")
    p.add_argument("--watch", action="store_true",
                   help="daemon mode: the positional arguments are directories; "
                        "new stable FITS files are served as they appear "
                        "(SIGTERM stops cleanly)")
    p.add_argument("--poll", type=float, default=2.0, help="watch poll interval, seconds")
    p.add_argument("--state", type=Path, default=None,
                   help="watch served-set JSON: a restarted daemon skips what "
                        "it served")
    p.add_argument("--max_polls", type=int, default=None,
                   help="watch drain mode: exit after N polls (2 = one "
                        "stability check and one serve pass)")
    _engine_flags(p)
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("http", help="HTTP inference service: POST a detxy FITS to "
                                    "/infer, get the WCS product back (GET "
                                    "/healthz, /stats)")
    p.add_argument("--host", default="127.0.0.1", help="bind address (0.0.0.0 to expose)")
    p.add_argument("--port", type=int, default=8572, help="TCP port (0 picks a free one)")
    _engine_flags(p)
    p.set_defaults(func=cmd_http)

    p = sub.add_parser("export", help="export a fit directory's best checkpoint to onnx/npz")
    p.add_argument("--checkpoint", type=Path, required=True,
                   help="checkpoint directory a port `fit` wrote (<checkpoint_root>/<model>)")
    p.add_argument("--out", type=Path, required=True, help=".onnx or .npz path")
    p.add_argument("--run_config", type=Path, required=True)
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("end2end", help="obsid PPS dir -> detxy -> SR/DN FITS products")
    p.add_argument("--pps", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--instrument", default="pn")
    p.add_argument("--max_expo", type=float, default=20.0)
    p.add_argument("--use_sas", action="store_true")
    p.add_argument("--plot", action="store_true",
                   help="also write PNG plots of the products (needs matplotlib)")
    _engine_flags(p)
    p.set_defaults(func=cmd_end2end)

    p = sub.add_parser("verify", help="real-weights parity gate: an ONNX graph vs the "
                                      "port's forward on FITS images (pixel <= tol, "
                                      "PSNR/SSIM table, int8 fidelity)")
    p.add_argument("--onnx", type=Path, required=True,
                   help="ONNX checkpoint (e.g. XMM-SuperRes.onnx)")
    p.add_argument("--run_config", type=Path, required=True)
    p.add_argument("--data", type=Path, default=None,
                   help="FITS directory (default: the real 20 ks example set, "
                        "infer/verify.py: default_example_files)")
    p.add_argument("--tol", type=float, default=1e-3, help="pixel-wise gate tolerance")
    p.add_argument("--limit", type=int, default=None, help="cap the number of files")
    p.add_argument("--no_int8", action="store_true",
                   help="skip the int8 recalibration fidelity gate")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of the forward and the lite runtime (default "
                        "cuda:0; cpu runs the kernels' plain versions)")
    p.set_defaults(func=cmd_verify)

    p = sub.add_parser("detxy", help="event list -> detxy image (native or SAS), on the host")
    p.add_argument("--pps", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--instrument", default="pn")
    p.add_argument("--max_expo", type=float, default=20.0)
    p.add_argument("--use_sas", action="store_true")
    p.set_defaults(func=cmd_detxy)
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except CliError as e:
        log.error("%s", e)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
