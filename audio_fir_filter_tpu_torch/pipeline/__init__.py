from .process_file import process_file
from .stream import (default_segment_len, filter_array_streamed,
                     filter_array_streamed_i16, sharded_filter_streamed)

__all__ = ["process_file", "default_segment_len", "filter_array_streamed",
           "filter_array_streamed_i16", "sharded_filter_streamed"]
