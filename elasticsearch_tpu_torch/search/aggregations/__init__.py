from elasticsearch_tpu_torch.search.aggregations.base import (parse_aggs,
                                                              reduce_aggs,
                                                              run_aggs)

__all__ = ["parse_aggs", "run_aggs", "reduce_aggs"]
