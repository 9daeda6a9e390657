"""INI defaults + command-line flags (counterpart of
friendly_stable_audio_tools_tpu/utils/config_args.py): every key of the
`[DEFAULTS]` section of `defaults.ini` becomes a `--key` flag (underscores
as dashes) whose type is inferred from the ini value."""

from __future__ import annotations

import argparse
import ast
import configparser
import typing as tp


def _parse_value(raw: str):
    raw = raw.strip()
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def get_all_args(defaults_file: str = "defaults.ini",
                 argv: tp.Optional[tp.Sequence[str]] = None,
                 parser: tp.Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """The INI's flags, added to `parser` (which may hold flags of its own)."""
    cp = configparser.ConfigParser()
    cp.read(defaults_file)
    parser = parser or argparse.ArgumentParser()
    if cp.has_section("DEFAULTS"):
        for key, raw in cp.items("DEFAULTS"):
            value = _parse_value(raw.split("#")[0])
            flag = "--" + key.replace("_", "-")
            if isinstance(value, bool):
                parser.add_argument(flag, dest=key, default=value,
                                    type=lambda s: s.lower() in ("1", "true", "yes"))
            elif isinstance(value, (int, float)):
                parser.add_argument(flag, dest=key, type=type(value), default=value)
            else:
                parser.add_argument(flag, dest=key, type=str, default=value)
    return parser.parse_args(argv)
