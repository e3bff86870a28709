"""The storage layer of the port. So far only what checkpoints and the
failure manager need: page checksums and the typed ``PageCorruption``.
The pager, the spill files and the tiered store come with the
out-of-core slice."""
from repro_torch.storage.spillfile import PageCorruption, page_checksum

__all__ = ["PageCorruption", "page_checksum"]
