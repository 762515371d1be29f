"""Configurations: `benchmark/configs/<name>.json` as a dict (what the
reference reads) and as the program's config objects."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path) -> dict:
    return json.loads((ROOT / path).read_text())


def _build(cls, fields: dict):
    """cls with `fields` over its defaults; lists become tuples."""
    kw = {f.name: fields[f.name] for f in dataclasses.fields(cls) if f.name in fields}
    unknown = set(fields) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})


def bundle(cfg: dict):
    """The program's ModelBundle for a configuration dict."""
    from posetraj_torch import configs as c
    from posetraj_torch.pipeline.svd_controlnet import ModelBundle

    unet = _build(c.UNetConfig, cfg["unet"])
    return ModelBundle(unet=unet, controlnet=c.ControlNetConfig(unet=unet, hint=_build(c.HintEncoderConfig, cfg["hint"])),
                       vae=_build(c.VAEConfig, cfg["vae"]), clip=_build(c.CLIPVisionConfig, cfg["clip"]),
                       scheduler=_build(c.SchedulerConfig, cfg["scheduler"]),
                       kernels=_build(c.KernelConfig, cfg.get("kernels", {})))


def train_config(cfg: dict, seed: int):
    """The program's TrainConfig: the configuration's recipe, its draws
    seeded from the run's seed."""
    from posetraj_torch.configs import TrainConfig

    return dataclasses.replace(_build(TrainConfig, cfg["train"]), seed=seed)


def as_dict(bundle_) -> dict:
    """The configuration dict of a program ModelBundle (for tests at small sizes)."""
    d = lambda x: json.loads(json.dumps(dataclasses.asdict(x)))
    return {"unet": d(bundle_.unet), "hint": d(bundle_.controlnet.hint), "vae": d(bundle_.vae),
            "clip": d(bundle_.clip), "scheduler": d(bundle_.scheduler)}
