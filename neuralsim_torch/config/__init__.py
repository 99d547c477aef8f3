"""The config reader: YAML or JSON files, ``${...}`` and ``${eval:...}``
interpolation, dot overrides on the command line (port of
neuralsim_tpu/config)."""
from .config import (BaseConfig, ConfigDict, load_config, parse_cli_overrides,
                     parse_value, resolve_interpolations, save_config)

__all__ = ["BaseConfig", "ConfigDict", "load_config", "parse_cli_overrides", "parse_value",
           "resolve_interpolations", "save_config"]
