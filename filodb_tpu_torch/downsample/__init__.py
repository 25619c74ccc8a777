"""Downsampling: the batch job's device functions, flush-time emission and
query-side resolution selection (the counterpart of
``filodb_tpu.downsample``).

(Reference: core/downsample/ChunkDownsampler.scala:38-353,
DownsamplePeriodMarker.scala, ShardDownsampler.scala:40;
spark-jobs/downsampler/chunk/DownsamplerMain.scala:69,
BatchDownsampler.scala:119,192; query side
DownsampledTimeSeriesShard.scala:63.)"""

from filodb_tpu_torch.downsample.job import DownsamplerJob, ds_dataset
from filodb_tpu_torch.downsample.store import DownsampledTimeSeriesStore

__all__ = ["DownsamplerJob", "DownsampledTimeSeriesStore", "ds_dataset"]
