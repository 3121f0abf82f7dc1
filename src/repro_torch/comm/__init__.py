"""Byte-accurate payload codecs + measured-bits accounting: the port of
``repro.comm``.

The flat sync's real ``(values, indices)`` payloads are encoded by
registered codecs (``repro_torch.comm.codecs``), counted on the device
(``measure_bits_torch``) and recorded per link
(``repro_torch.comm.accounting``): the depth-2 probe
(``make_sync_probe``) and the depth > 2 one (``make_hier_sync_probe``),
which measures every tier boundary of the tiered cascade.
"""
from repro_torch.comm.accounting import (
    LINKS, PayloadLedger, access_bits, boundary_links, link_names,
    make_hier_sync_probe, make_sync_probe,
)
from repro_torch.comm.codecs import CODECS, Codec, get_codec, list_codecs

__all__ = [
    "CODECS", "Codec", "get_codec", "list_codecs",
    "LINKS", "PayloadLedger", "access_bits", "boundary_links",
    "link_names", "make_hier_sync_probe", "make_sync_probe",
]
