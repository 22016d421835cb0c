"""Convert Python readers into RecordIO files (counterpart of
paddle_tpu/recordio_writer.py; the native chunked writer in recordio.py
does the IO)."""
from __future__ import annotations

import numpy as np

from . import recordio


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    samples = []
    for sample in reader_creator():
        arrs = [np.asarray(f) for f in (sample if isinstance(sample, (list, tuple)) else [sample])]
        samples.append(arrs)
    recordio.write_arrays(filename, samples, max_chunk_records=max_num_records)
    return len(samples)


def convert_reader_to_recordio_files(filename, batch_per_file, reader_creator,
                                     feeder=None, compressor=None,
                                     max_num_records=1000, feed_order=None):
    buf, idx, written = [], 0, []
    for sample in reader_creator():
        arrs = [np.asarray(f) for f in (sample if isinstance(sample, (list, tuple)) else [sample])]
        buf.append(arrs)
        if len(buf) == batch_per_file:
            path = f"{filename}-{idx:05d}"
            recordio.write_arrays(path, buf, max_chunk_records=max_num_records)
            written.append(path)
            buf, idx = [], idx + 1
    if buf:
        path = f"{filename}-{idx:05d}"
        recordio.write_arrays(path, buf, max_chunk_records=max_num_records)
        written.append(path)
    return written
