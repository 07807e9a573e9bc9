from elasticsearch_tpu_torch.analysis.analyzer import Analyzer, get_analyzer, build_custom_analyzer
from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry

__all__ = ["Analyzer", "get_analyzer", "build_custom_analyzer", "AnalysisRegistry"]
