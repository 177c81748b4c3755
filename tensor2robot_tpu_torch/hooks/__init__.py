"""Training-loop hooks: export listeners, async and TD3 exports, golden
values, config and variable logging, profiling."""

from tensor2robot_tpu_torch.hooks.async_export_hook_builder import (
    AsyncExportHook,
    AsyncExportHookBuilder,
    default_create_export_fn,
)
from tensor2robot_tpu_torch.hooks.checkpoint_hooks import (
    CheckpointExportListener,
    LaggedCheckpointListener,
)
from tensor2robot_tpu_torch.hooks.gin_config_hook_builder import (
    ConfigLoggerHook,
    ConfigLoggerHookBuilder,
)
from tensor2robot_tpu_torch.hooks.golden_values_hook_builder import (
    GoldenValuesHook,
    GoldenValuesHookBuilder,
    add_golden_tensor,
    load_golden_values,
)
from tensor2robot_tpu_torch.hooks.hook_builder import Hook, HookBuilder, HookContext
from tensor2robot_tpu_torch.hooks.profiling_hook_builder import (
    ProfilerHook,
    ProfilerHookBuilder,
    StepTimingHook,
    StepTimingHookBuilder,
)
from tensor2robot_tpu_torch.hooks.td3 import TD3Hooks
from tensor2robot_tpu_torch.hooks.variable_logger_hook import (
    VariableLoggerHook,
    VariableLoggerHookBuilder,
)
