"""The host data pipeline: records, sampling, decode, transforms, priors,
the dataset and the loader that feeds the card."""

from .dataset import VideoDataset
from .loader import DataLoader, collate, create_dataloader
from .priors import attention_prior, attention_window_size
from .records import EpicRecord, load_annotations, read_vid_list, record_from_row
from .sampling import flow_stack_indices, sample_indices, segment_offsets

__all__ = [
    "DataLoader",
    "EpicRecord",
    "VideoDataset",
    "attention_prior",
    "attention_window_size",
    "collate",
    "create_dataloader",
    "flow_stack_indices",
    "load_annotations",
    "read_vid_list",
    "record_from_row",
    "sample_indices",
    "segment_offsets",
]
