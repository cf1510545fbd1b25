"""The streams layer of the port: so far the admission gate (the app,
router and pipeline modules of the reference's ``streams`` package are
ROADMAP Queue 1 item 7)."""
from repro_torch.streams.admission import (AdmissionConfig, AdmissionController,
                                           AdmissionDecision, AdmissionState,
                                           admission_row)

__all__ = ["AdmissionConfig", "AdmissionController", "AdmissionDecision",
           "AdmissionState", "admission_row"]
