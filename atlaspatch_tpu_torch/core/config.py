"""Validated configuration dataclasses.

Capability parity with the reference config system (reference:
atlas_patch/core/config.py:40-179). Device strings name torch devices:
"cpu", "cuda", "cuda:<index>"; "gpu" and "gpu:<index>" are accepted as
aliases of "cuda".

Validation is table-driven: each config class declares its numeric constraints
and file-existence requirements as class-level rows, and a shared walker in
``_TableValidated`` enforces them. Per-class normalization (defaults, device
and precision canonicalization, dedupe) lives in a ``_normalize`` hook that
runs between the existence and numeric passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

# --- declarative constraint vocabulary --------------------------------------

def _gt0(v) -> bool:
    return v > 0


def _ge0(v) -> bool:
    return v >= 0


def _unit_interval(v) -> bool:
    return 0 <= v <= 1


_CONSTRAINT_TEXT = {
    _gt0: "> 0",
    _ge0: ">= 0",
    _unit_interval: "between 0 and 1",
}


class _TableValidated:
    """Shared ``validated()`` driven by class-level constraint tables.

    ``_REQUIRED_PATHS``: (attr, human label[, mandatory]) rows — attr must
    exist on disk when not None; when the row is marked mandatory, None
    itself is a validation error (the value has no usable default).
    ``_NUMERIC``: (attr, predicate, human label) rows — attr must satisfy the
    predicate when not None. Subclasses normalize defaults / canonical
    spellings in ``_normalize`` (runs between the two passes, so it may fill
    in None defaults that the numeric pass then checks).
    """

    _REQUIRED_PATHS: tuple = ()
    _NUMERIC: tuple = ()

    def validated(self):
        for row in self._REQUIRED_PATHS:
            attr, label, mandatory = (*row, False)[:3]
            value = getattr(self, attr)
            if value is None:
                if mandatory:
                    raise ValueError(f"{label} is required, got None")
                continue
            if not Path(value).exists():
                raise FileNotFoundError(f"{label} not found: {value}")
        self._normalize()
        for attr, predicate, label in self._NUMERIC:
            value = getattr(self, attr)
            if value is not None and not predicate(value):
                raise ValueError(
                    f"{label} must be {_CONSTRAINT_TEXT[predicate]}, got {value}"
                )
        return self

    def _normalize(self) -> None:  # per-class hook
        return


def normalize_device(device: str) -> str:
    """Normalize a device request to a torch device string.

    Accepts "cpu", "cuda", "cuda:<index>", and "gpu"/"gpu:<index>" as aliases
    of "cuda" (reference validates cuda strings at core/config.py:25-37).
    """
    dev = device.strip().lower()
    if dev == "cpu":
        return "cpu"
    for alias in ("cuda", "gpu"):
        if dev == alias:
            return "cuda"
        if dev.startswith(alias + ":"):
            suffix = dev.split(":", 1)[1]
            if not suffix.isdigit():
                raise ValueError(
                    f"Invalid device specification '{device}'. "
                    f"Use '{alias}' or '{alias}:<index>'."
                )
            return f"cuda:{suffix}"
    raise ValueError(
        f"device must be 'cpu', 'cuda', or 'cuda:<index>' (gpu accepted as an alias), "
        f"got {device}"
    )


@dataclass
class SegmentationConfig(_TableValidated):
    """SAM2 tissue-segmentation settings (reference: core/config.py:40-58)."""

    checkpoint_path: Path | None = None
    config_path: Path | None = None
    device: str = "cuda"
    thumbnail_power: float = 1.25
    thumbnail_max: int = 1024
    batch_size: int = 1
    mask_threshold: float = 0.0
    # float32 (default) for strict reference parity; bfloat16 casts every
    # parameter and runs the whole model in bf16 (boundary pixels may differ
    # by a hair).
    precision: str = "float32"
    # SAM2 model input resolution override. None keeps the architecture
    # YAML's size (1024, the reference's hardcoded resolution —
    # atlas_patch/services/segmentation.py:25-237). Thumbnails are at most
    # `thumbnail_max` px on the long side, so running the trunk at a lower
    # square size processes the same source pixels with quadratically less
    # trunk work; hiera's pos-embeds interpolate to any grid. Quality at
    # reduced sizes must be validated per checkpoint; the reference-parity
    # default stays 1024.
    input_size: int | None = None
    # True when input_size came from the --fast preset rather than an
    # explicit flag: the predictor then falls back to the architecture's
    # native size (with a log line) if the window spec cannot tile it,
    # instead of hard-failing a preset the user never typed.
    input_size_preset: bool = False

    _REQUIRED_PATHS = (
        ("checkpoint_path", "Checkpoint"),
        ("config_path", "SAM2 config"),
    )
    _NUMERIC = (
        ("thumbnail_max", _gt0, "thumbnail_max"),
        ("batch_size", _gt0, "segmentation batch_size"),
    )

    def _normalize(self) -> None:
        self.device = normalize_device(str(self.device))
        if self.input_size is not None:
            size = int(self.input_size)
            # hiera constraint: the stride-4 patch grid must tile the first
            # stage's 8px windows, and the FPN halves it twice more.
            if size <= 0 or size % 32:
                raise ValueError(
                    f"segmentation input_size must be a positive multiple of 32, "
                    f"got {self.input_size}"
                )
            self.input_size = size
        prec = str(self.precision).lower()
        if prec == "float16":
            prec = "bfloat16"  # the port's one reduced precision
        if prec not in ("float32", "bfloat16"):
            raise ValueError(
                f"segmentation precision must be float32/bfloat16, got {self.precision}"
            )
        self.precision = prec


@dataclass
class ExtractionConfig(_TableValidated):
    """Patch-grid extraction settings (reference: core/config.py:61-89)."""

    patch_size: int
    target_magnification: int
    step_size: int | None = None
    workers: int | None = None
    max_open_slides: int | None = None
    tissue_threshold: float = 0.01
    white_threshold: int = 15
    black_threshold: int = 50
    fast_mode: bool = True
    write_batch: int = 8192

    _NUMERIC = (
        ("patch_size", _gt0, "patch_size"),
        ("target_magnification", _gt0, "target_magnification"),
        ("step_size", _gt0, "step_size"),
        ("tissue_threshold", _unit_interval, "tissue_threshold"),
        ("white_threshold", _gt0, "white_threshold"),
        ("black_threshold", _gt0, "black_threshold"),
        ("write_batch", _gt0, "write_batch"),
        ("workers", _gt0, "workers"),
        ("max_open_slides", _gt0, "max_open_slides"),
    )

    def _normalize(self) -> None:
        if self.step_size is None:
            self.step_size = self.patch_size
        if self.max_open_slides is None:
            self.max_open_slides = 200


@dataclass
class FeatureExtractionConfig(_TableValidated):
    """Patch-embedding settings (reference: core/config.py:92-121).

    precision selects the on-device compute dtype.
    """

    extractors: list[str]
    batch_size: int = 32
    device: str = "cuda"
    num_workers: int = 4
    precision: str = "float32"
    plugins: list[Path] = field(default_factory=list)

    _NUMERIC = (
        ("batch_size", _gt0, "feature batch_size"),
        ("num_workers", _ge0, "feature num_workers"),
    )
    _PRECISIONS = ("bfloat16", "float16", "float32", "int8")

    def _normalize(self) -> None:
        if not self.extractors:
            raise ValueError("At least one feature extractor must be provided.")
        # Case-insensitive dedupe, order-preserving: a repeated name is one
        # unit of work everywhere (progress totals, embed loops).
        seen: set[str] = set()
        self.extractors = [
            n for n in self.extractors
            if str(n).lower() not in seen and not seen.add(str(n).lower())
        ]
        self.device = normalize_device(str(self.device))
        prec = str(self.precision).lower()
        if prec not in self._PRECISIONS:
            raise ValueError(
                f"precision must be one of {sorted(self._PRECISIONS)}, got {self.precision}"
            )
        self.precision = prec
        resolved: list[Path] = []
        for plugin in self.plugins:
            plugin_path = Path(plugin)
            if not plugin_path.exists():
                raise FileNotFoundError(f"Feature plugin not found: {plugin_path}")
            resolved.append(plugin_path.resolve())
        self.plugins = resolved


@dataclass
class OutputConfig(_TableValidated):
    """Output toggles + root (reference: core/config.py:124-135)."""

    output_root: Path
    save_images: bool = False
    visualize_grids: bool = False
    visualize_mask: bool = False
    visualize_contours: bool = False
    skip_existing: bool = True

    def _normalize(self) -> None:
        self.output_root = Path(self.output_root)
        self.output_root.mkdir(parents=True, exist_ok=True)


@dataclass
class ProcessingConfig(_TableValidated):
    """Input discovery settings (reference: core/config.py:138-149)."""

    input_path: Path
    recursive: bool = False
    mpp_csv: Path | None = None

    _REQUIRED_PATHS = (
        ("input_path", "Input path", True),
        ("mpp_csv", "MPP CSV"),
    )


@dataclass
class VisualizationConfig(_TableValidated):
    """Visualization sizing (reference: core/config.py:152-157)."""

    thumbnail_size: int = 1024

    _NUMERIC = (("thumbnail_size", _gt0, "thumbnail_size"),)


@dataclass
class AppConfig:
    """Aggregate validated app config (reference: core/config.py:161-179)."""

    processing: ProcessingConfig
    segmentation: SegmentationConfig
    extraction: ExtractionConfig
    output: OutputConfig
    features: FeatureExtractionConfig | None = None
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    device: str = "cuda"

    def validated(self) -> "AppConfig":
        for section in ("processing", "segmentation", "extraction", "output",
                        "features", "visualization"):
            cfg = getattr(self, section)
            if cfg is None:
                if section == "features":  # the one genuinely optional section
                    continue
                raise ValueError(f"{section} config is required, got None")
            setattr(self, section, cfg.validated())
        self.device = normalize_device(self.device)
        return self
