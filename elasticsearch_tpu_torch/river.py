"""Rivers: absent on purpose (a documented stub).

Port of elasticsearch_tpu/river.py (reference: org/elasticsearch/river/,
the pull-based ingestion plugins deprecated in ES 1.5 and removed in the
2.0 line). The replacements are the ones ES pointed users at: push
ingestion through ``POST /_bulk`` or an external feeder using the client.
Registering a river raises, as the removal did.
"""
from __future__ import annotations

from elasticsearch_tpu_torch.utils.errors import IllegalArgumentException


def register_river(name: str, config: dict) -> None:
    raise IllegalArgumentException(
        f"rivers were removed in the 2.0 line (river [{name}] cannot be "
        f"registered); use the _bulk API or an external feeder instead")
