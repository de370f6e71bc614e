"""Workload generation (Feitelson model, Poisson arrivals, SWF replay,
open-loop serving traffic)."""
from repro_torch.workload.feitelson import (evolving_phases_for,
                                            feitelson_sizes, make_workload,
                                            poisson_arrivals)
from repro_torch.workload.swf import (EVOLVING, MALLEABLE, MOLDABLE, RIGID,
                                      SERVING, MalleabilityMix, SWFJob,
                                      SWFTrace, annotate_malleability,
                                      clamp_band, jobs_from_swf, parse_swf)
from repro_torch.workload.traffic import (DiurnalCurve, TrafficGenerator,
                                          TrafficSpec)

__all__ = ["evolving_phases_for", "feitelson_sizes", "make_workload",
           "poisson_arrivals", "SWFJob", "SWFTrace", "MalleabilityMix",
           "annotate_malleability", "clamp_band", "jobs_from_swf",
           "parse_swf", "RIGID", "MOLDABLE", "MALLEABLE", "EVOLVING",
           "SERVING", "DiurnalCurve", "TrafficGenerator", "TrafficSpec"]
