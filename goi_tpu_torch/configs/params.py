"""Config system: dataclasses + reflective argparse wiring.

Counterpart of goi_tpu/configs/params.py (the role of
ref:arguments/__init__.py:8-113): saved configs round-trip through JSON,
not an `eval()` of a repr, and `cfg_args.json` has the JAX package's
layout ({class name: fields}), so a run directory written by either
package loads in the other. `OptimConfig` lives in train/optim.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, Namespace
from typing import Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """(ref:arguments/__init__.py:36-55)."""

    sh_degree: int = 3
    sem_dim: int = 10
    ape_dim: int = 256
    clip_dim: int = 512
    tab_len: int = 300
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """(ref:arguments/__init__.py:57-62). Kept for the reference's flags:
    the port always computes SH colors and covariances in its own
    preprocess, and `debug` is accepted and not used yet."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


_SHORTHAND = {"source_path": "-s", "model_path": "-m", "images": "-i",
              "resolution": "-r", "white_background": "-w"}


def add_params(parser: ArgumentParser, cls: Type[T], name: str) -> None:
    """One flag per field of the dataclass `cls` (booleans as
    store_true), with the reference's one-letter shorthands."""
    group = parser.add_argument_group(name)
    for f in dataclasses.fields(cls):
        flag = "--" + f.name
        extra = [_SHORTHAND[f.name]] if f.name in _SHORTHAND else []
        if f.type in (bool, "bool"):
            group.add_argument(flag, *extra, action="store_true",
                               default=f.default)
        else:
            t = {int: int, float: float, str: str,
                 "int": int, "float": float, "str": str}[f.type]
            group.add_argument(flag, *extra, type=t, default=f.default)


def extract_params(args: Namespace, cls: Type[T]) -> T:
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def save_params(model_path: str, *param_objs) -> None:
    """Persist configs as cfg_args.json in the run directory (the role
    of the cfg_args dump, ref:train.py:216-217)."""
    os.makedirs(model_path, exist_ok=True)
    blob = {type(p).__name__: dataclasses.asdict(p) for p in param_objs}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(blob, f, indent=2)


def load_saved_params(model_path: str, cls: Type[T]) -> T:
    """Merge a saved run config back (role of get_combined_args,
    ref:arguments/__init__.py:93-113, minus the eval()); the defaults
    when the run directory has none."""
    path = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(path):
        return cls()
    with open(path) as f:
        blob = json.load(f)
    d = blob.get(cls.__name__, {})
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def combined_params(args: Namespace, cls: Type[T]) -> T:
    """get_combined_args' precedence (ref:arguments/__init__.py:93-113):
    the run directory's saved config overrides the defaults, and a flag
    given with another value than its default overrides the saved one."""
    saved = load_saved_params(args.model_path, cls)
    cli = extract_params(args, cls)
    base = cls()
    return cls(**{f.name: (getattr(cli, f.name)
                           if getattr(cli, f.name) != getattr(base, f.name)
                           else getattr(saved, f.name))
                  for f in dataclasses.fields(cls)})
