"""The streams layer of the port: the app model, the stream router (the
SPTLB front end of the stream runtime) and the admission gate.  The token
pipeline of the reference's ``streams`` package (``TokenStream``,
``Prefetcher``, ``PrefetchStats``, ``StreamConfig``, ``BackpressureError``)
is ROADMAP Queue 1 item 7b."""
from repro_torch.streams.admission import (AdmissionConfig, AdmissionController,
                                           AdmissionDecision, AdmissionState,
                                           admission_row)
from repro_torch.streams.app import StreamApp, demo_apps
from repro_torch.streams.router import PodSlice, StreamRouter, build_cluster

__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionDecision",
           "AdmissionState", "admission_row",
           "StreamApp", "demo_apps", "PodSlice", "StreamRouter", "build_cluster"]
