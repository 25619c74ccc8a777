"""Operational batch jobs (the reference's spark-jobs family beyond the
chunk downsampler): downsample-index migration, cross-store chunk
repair/copy, and cardinality busting (the counterpart of
``filodb_tpu.jobs``)."""

from filodb_tpu_torch.jobs.index_migration import DSIndexJob, DSIndexStats
from filodb_tpu_torch.jobs.chunk_copier import ChunkCopier, ChunkCopierStats
from filodb_tpu_torch.jobs.cardbuster import CardBuster, CardBusterStats

__all__ = ["DSIndexJob", "DSIndexStats", "ChunkCopier",
           "ChunkCopierStats", "CardBuster", "CardBusterStats"]
