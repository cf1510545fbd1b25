"""The streams layer of the port: the app model, the stream router (the
SPTLB front end of the stream runtime), the admission gate and the token
pipeline that feeds training (``TokenStream``, ``Prefetcher``)."""
from repro_torch.streams.admission import (AdmissionConfig, AdmissionController,
                                           AdmissionDecision, AdmissionState,
                                           admission_row)
from repro_torch.streams.app import StreamApp, demo_apps
from repro_torch.streams.pipeline import (BackpressureError, Prefetcher, PrefetchStats,
                                          StreamConfig, TokenStream)
from repro_torch.streams.router import PodSlice, StreamRouter, build_cluster

__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionDecision",
           "AdmissionState", "admission_row",
           "StreamApp", "demo_apps", "BackpressureError", "Prefetcher",
           "PrefetchStats", "StreamConfig", "TokenStream", "PodSlice",
           "StreamRouter", "build_cluster"]
