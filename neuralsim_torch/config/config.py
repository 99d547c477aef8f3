"""ConfigDict, config files, interpolation and command-line overrides (port of
neuralsim_tpu/config/config.py:22-210).

Interpolation, resolved against the whole config after the overrides:

* ``${path.to.key}``: the value at that dotted path (a list index is a
  number);
* ``${eval:"python expr"}``: the expression, evaluated with the root config
  bound as ``cfg`` and ``math``, ``np`` and a few builtins; a ``${...}``
  inside it is replaced by the ``repr`` of its value first.

A dot override ``--training.num_iters=5000`` sets a nested key; its value is
read as a YAML flow value (:func:`parse_value`: numbers, booleans, null, flow
lists and maps, quoted and plain strings, with PyYAML's scalar rules), without
PyYAML. PyYAML is imported only where a ``.yaml`` file is read; a ``.json``
file is read with ``json``. :func:`save_config` writes JSON (a run's
``config.json``, where the JAX package writes ``config.yaml``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence


class ConfigDict(dict):
    """A dict with attribute access and a deep merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [ConfigDict._wrap(x) for x in v]
        return v

    @classmethod
    def from_dict(cls, d: Dict) -> "ConfigDict":
        return cls._wrap(d)

    def deep_update(self, other: Dict) -> "ConfigDict":
        for k, v in other.items():
            if k in self and isinstance(self[k], dict) and isinstance(v, dict):
                ConfigDict._wrap(self[k]).deep_update(v)
            else:
                self[k] = ConfigDict._wrap(v)
        return self

    def to_plain(self) -> Dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v
        return conv(self)


_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _get_path(root: Dict, path: str):
    cur: Any = root
    for part in path.split("."):
        cur = cur[int(part)] if isinstance(cur, list) else cur[part]
    return cur


def _resolve_value(val: str, root: Dict, depth: int = 0):
    """One string value with its interpolations resolved."""
    if depth > 16:
        raise ValueError(f"interpolation loop: {val}")
    m = _INTERP_RE.fullmatch(val.strip())
    if m:
        expr = m.group(1)
        if expr.startswith("eval:"):
            return _run_eval(expr[5:], root)
        out = _get_path(root, expr)
        if isinstance(out, str) and _INTERP_RE.search(out):
            return _resolve_value(out, root, depth + 1)
        return out

    def sub(mm):                        # an interpolation inside a longer string
        expr = mm.group(1)
        if expr.startswith("eval:"):
            v = _run_eval(expr[5:], root)
        else:
            v = _get_path(root, expr)
            if isinstance(v, str) and _INTERP_RE.search(v):
                v = _resolve_value(v, root, depth + 1)
        return str(v)

    return _INTERP_RE.sub(sub, val) if _INTERP_RE.search(val) else val


def _run_eval(src: str, root: Dict):
    src = src.strip()
    if len(src) >= 2 and src[0] == src[-1] and src[0] in "\"'":
        src = src[1:-1]
    src = _INTERP_RE.sub(lambda mm: repr(_get_path(root, mm.group(1))), src)
    import numpy as np
    env = {"cfg": root, "math": math, "np": np, "min": min, "max": max, "int": int,
           "float": float, "len": len, "abs": abs, "round": round, "__builtins__": {}}
    return eval(src, env)  # noqa: S307 - expressions written by the config's author


def resolve_interpolations(cfg: Dict, root: Optional[Dict] = None) -> ConfigDict:
    """Every string interpolation of ``cfg`` resolved against ``root``
    (default ``cfg``). A nested form such as ``${eval:"${far} / 100"}``
    resolves its inner references first, then the outer expression on a
    later pass."""
    root = root if root is not None else cfg

    def walk(node):
        if isinstance(node, dict):
            return ConfigDict({k: walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [walk(v) for v in node]
        for _ in range(8):
            if not (isinstance(node, str) and _INTERP_RE.search(node)):
                break
            node = _resolve_value(node, root)
        return node

    return walk(cfg)


def _read_file(path: str) -> Dict:
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        import yaml
        return yaml.safe_load(f) or {}


def load_config(path: str, overrides: Optional[Sequence[str]] = None,
                resolve: bool = True) -> ConfigDict:
    """Read a ``.yaml`` (PyYAML) or ``.json`` config, with its ``_parent_``
    chain (a file whose keys this one updates), then the dot ``overrides``,
    then, with ``resolve``, the interpolations."""
    cfg = ConfigDict.from_dict(_read_file(path))
    parent = cfg.pop("_parent_", None)
    if parent:
        pcfg = load_config(os.path.join(os.path.dirname(path), parent), resolve=False)
        pcfg.deep_update(cfg)
        cfg = pcfg
    if overrides:
        cfg.deep_update(parse_cli_overrides(overrides))
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg


def save_config(cfg: Dict, path: str) -> None:
    """Write ``cfg`` as JSON."""
    with open(path, "w") as f:
        json.dump(ConfigDict._wrap(cfg).to_plain(), f, indent=2)


# PyYAML's implicit scalar types (YAML 1.1), as yaml.safe_load resolves a
# plain scalar
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**{s: True for s in "yes Yes YES true True TRUE on On ON".split()},
         **{s: False for s in "no No NO false False FALSE off Off OFF".split()}}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _sexagesimal(s: str, conv):
    sign = -1 if s.startswith("-") else 1
    total = conv(0)
    for part in s.lstrip("+-").split(":"):
        total = total * 60 + conv(part)
    return sign * total


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s.startswith("-") else 1
    body = s.lstrip("+-")
    if ":" in body:
        return _sexagesimal(s, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if len(body) > 1 and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(s: str) -> float:
    s = s.replace("_", "").lower()
    if s.endswith((".inf", ".nan")):
        return float(s.replace(".", ""))
    if ":" in s:
        return _sexagesimal(s, float)
    return float(s)


def _scalar(s: str) -> Any:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return json.loads(s)
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    return s


def _split_flow(body: str) -> List[str]:
    """The items of a flow collection's body, split at its top-level commas."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
            if depth < 0:
                raise ValueError(body)
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if quote or depth:
        raise ValueError(body)
    if cur.strip():             # not after a trailing comma
        items.append(cur)
    return items


def _flow(s: str) -> Any:
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_flow(x) for x in _split_flow(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        out = {}
        for item in _split_flow(s[1:-1]):
            k, sep, v = item.partition(": ")
            if not sep:
                k, v = item.rstrip().rstrip(":"), ""
            out[_scalar(k)] = _flow(v)
        return out
    if s.startswith(("[", "{")):
        raise ValueError(s)
    return _scalar(s)


def parse_value(v: str) -> Any:
    """A command-line value as YAML reads it: a flow list or map, or a scalar
    (null, bool, int, float or string). A value that does not parse is kept as
    the string it is, as the JAX reader keeps one that PyYAML refuses."""
    if v.lstrip().startswith("${"):
        return v
    try:
        return _flow(v)
    except (ValueError, json.JSONDecodeError):
        return v


def parse_cli_overrides(pairs: Sequence[str]) -> ConfigDict:
    """['a.b.c=1', '--x=foo'] -> a nested ConfigDict ({'a': {'b': {'c': 1}},
    'x': 'foo'}); an item without '=' is skipped."""
    out = ConfigDict()
    for pair in pairs:
        pair = pair.lstrip("-")
        if "=" not in pair:
            continue
        k, v = pair.split("=", 1)
        cur = out
        parts = k.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, ConfigDict())
        cur[parts[-1]] = parse_value(v)
    return out


class BaseConfig:
    """The command line of the tools: ``--config path.yaml`` (or ``.json``),
    dot overrides ``--aaa.bbb=ccc``, ``--resume_dir`` (whose ``config.json``
    is read where no ``--config`` is given) and ``--device_ids``."""

    def __init__(self, description: str = ""):
        # allow_abbrev=False: argparse would otherwise read e.g. --res=48 as an
        # abbreviation of --resume_dir
        self.parser = argparse.ArgumentParser(description=description, allow_abbrev=False)
        self.parser.add_argument("--config", type=str, default=None)
        self.parser.add_argument("--resume_dir", type=str, default=None)
        self.parser.add_argument("--device_ids", type=str, default="0")

    def parse(self, argv: Optional[List[str]] = None) -> ConfigDict:
        args, unknown = self.parser.parse_known_args(argv)
        cfg_path = args.config
        if cfg_path is None and args.resume_dir:
            cfg_path = os.path.join(args.resume_dir, "config.json")
        cfg = load_config(cfg_path, overrides=unknown) if cfg_path else \
            parse_cli_overrides(unknown)
        for k, v in vars(args).items():
            if k != "config":
                cfg[k] = v
        return cfg
