"""Pretrained-checkpoint locator (counterpart of ``diff_pruning_tpu/utils/ckpt_util.py``):
the DDIM codebase's named checkpoints, their cache layout and MD5s.

Nothing is downloaded: :func:`get_ckpt_path` resolves a name against files
placed in the cache layout beforehand and checks their MD5, and raises with
where to put a missing file. Convert a resolved checkpoint with
``python -m diff_pruning_tpu_torch.cli.convert_checkpoints ddim <ckpt> <out_dir>``.
"""

from __future__ import annotations

import hashlib
import os

# name -> path under the cache root
CKPT_MAP = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom": "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church": "ema_diffusion_lsun_church_model/model-4432000.ckpt",
    "celeba": "ema_diffusion_celeba_model/model.ckpt",
    "ema_celeba": "ema_diffusion_celeba_model/model.ckpt",
}

# name -> the file's MD5
MD5_MAP = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def md5_hash(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def default_cache_root() -> str:
    # ./run/cache under the working directory (the DDIM codebase's own
    # layout) unless XDG_CACHE_HOME is set
    cachedir = os.environ.get("XDG_CACHE_HOME",
                              os.path.expanduser("./run/cache"))
    return os.path.join(cachedir, "diffusion_models_converted")


def get_ckpt_path(name: str, root: str = None, check: bool = False) -> str:
    """The path of the named checkpoint under ``root`` (default
    :func:`default_cache_root`). Raises KeyError for an unknown name,
    FileNotFoundError (saying where to place it) when the file is absent, and
    with ``check`` ValueError when its MD5 differs from the known one."""
    if "church_outdoor" in name:
        name = name.replace("church_outdoor", "church")
    if name not in CKPT_MAP:
        raise KeyError(f"unknown checkpoint {name!r}; known: {sorted(CKPT_MAP)}")
    root = root if root is not None else default_cache_root()
    path = os.path.join(root, CKPT_MAP[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {name!r} not found at {path}; nothing is downloaded: "
            "place the file there, then convert it with `python -m "
            "diff_pruning_tpu_torch.cli.convert_checkpoints ddim "
            f"{path} <out_dir>`")
    if check:
        md5 = md5_hash(path)
        if MD5_MAP.get(name) and md5 != MD5_MAP[name]:
            raise ValueError(f"{path}: MD5 {md5} != expected {MD5_MAP[name]}")
    return path
