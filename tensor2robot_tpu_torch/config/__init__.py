"""gin-style configuration: registry, bindings, macros, scopes, includes."""

from tensor2robot_tpu_torch.config.registry import (
    ConfigError,
    bind_macro,
    bind_parameter,
    clear_config,
    config_scope,
    configurable,
    external_configurable,
    get_configurable,
    operative_config_str,
    parse_config,
    parse_config_file,
    parse_config_files_and_bindings,
    query_parameter,
    save_operative_config,
)
