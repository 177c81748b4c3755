"""Export layer: the exported-model directory, its serving interfaces and
the train-time export policies."""

from tensor2robot_tpu_torch.export.aot import (
    AOTCorrupt,
    AOTError,
    AOTKeyMismatch,
    device_topology,
)
from tensor2robot_tpu_torch.export.export_generators import (
    AbstractExportGenerator,
    DefaultExportGenerator,
    QuantServingModule,
)
from tensor2robot_tpu_torch.export.exporters import (
    BestExporter,
    DirectoryVersionGC,
    Exporter,
    LatestExporter,
    create_default_exporters,
    create_valid_result_larger,
    create_valid_result_smaller,
)
from tensor2robot_tpu_torch.export.quantization import (
    dequantize_variables,
    quantize_variables,
)
from tensor2robot_tpu_torch.export.serve_quant import (
    SERVE_QUANT_REGIMES,
    QuantParityError,
)
from tensor2robot_tpu_torch.export.saved_model import (
    ExportedModel,
    is_valid_export_dir,
    latest_export_dir,
    list_export_dirs,
    save_exported_model,
)
from tensor2robot_tpu_torch.export.streaming import (
    StreamingExportedPolicy,
    StreamingStepRunner,
    is_streaming_export,
    save_streaming_export,
)
