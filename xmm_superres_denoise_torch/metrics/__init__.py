"""Metrics of the port: the core functions, the accumulating collections
and the extended suite (the JAX package's `metrics/__init__.py`)."""

from .collection import CORE_METRIC_NAMES, MetricBank, XMMMetricCollection
from .extended import EXT_METRIC_NAMES, register_extended_metrics
from .functional import l1, l2, ms_ssim, poisson_nll, psnr, ssim


def get_metrics(dataset_normalizer, scaling_normalizers, prefix):
    """Core collection (the reference's metrics/xmm_metric_collection.py:14-38)."""
    return XMMMetricCollection(dataset_normalizer, scaling_normalizers, prefix)


def get_ext_metrics(dataset_normalizer, scaling_normalizers, prefix):
    return XMMMetricCollection(
        dataset_normalizer, scaling_normalizers, prefix, metric_names=EXT_METRIC_NAMES
    )


def get_in_metrics(dataset_normalizer, scaling_normalizers, prefix):
    return XMMMetricCollection(
        dataset_normalizer, scaling_normalizers, prefix, input_baseline=True
    )


def get_in_ext_metrics(dataset_normalizer, scaling_normalizers, prefix):
    return XMMMetricCollection(
        dataset_normalizer,
        scaling_normalizers,
        prefix,
        metric_names=EXT_METRIC_NAMES,
        input_baseline=True,
    )


__all__ = [
    "CORE_METRIC_NAMES", "EXT_METRIC_NAMES", "MetricBank", "XMMMetricCollection",
    "get_metrics", "get_ext_metrics", "get_in_metrics", "get_in_ext_metrics", "l1", "l2",
    "ms_ssim", "poisson_nll", "psnr", "ssim", "register_extended_metrics",
]
