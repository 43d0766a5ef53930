"""repro_torch.measure — empirical measurement of the §5 model's terms
on the running device (paper §5/§6.3).

TEMPI's claim is that non-contiguous transfer performance "can be
modeled with empirical system measurements", recorded once to the file
system and used to pick the cheapest strategy transparently.  This
package owns that data end to end:

* :mod:`repro_torch.measure.bench`       — timed sweeps of the pack,
  unpack, wire (flat, per mesh axis, per link class), contiguous-copy,
  compress and stencil terms (``calibrate_params``);
* :mod:`repro_torch.measure.fingerprint` — the keys everything below is
  stored under: the committed type's content hash, and the system's
  (platform, device name, ranks, torch version);
* :mod:`repro_torch.measure.store`       — the versioned on-disk
  SystemParams envelopes (``load_or_calibrate``) and the checked-in
  ``h100_params.json``;
* :mod:`repro_torch.measure.decisions`   — the persistent selection
  cache and audit log a model records into and pins from;
* :mod:`repro_torch.measure.production`  — a Communicator wired with
  both.

Lifecycle: calibrate once -> store -> load in any process -> select
(fingerprint-keyed, reproducible) -> audit.  The envelope and the
decisions file are the reference's formats, so ``repro.measure`` reads
them.  Run the calibration with ``python -m repro_torch.measure``.
"""

from repro_torch.measure.bench import (
    calibrate_params,
    fit_latency_bandwidth,
    measure_copy_table,
    measure_pack_table,
    measure_compress_table,
    measure_stencil_table,
    measure_link_class_tables,
    measure_unpack_table,
    measure_wire_table,
    measure_wire_tables,
    time_fn,
)
from repro_torch.measure.decisions import DECISIONS_FORMAT, Decision, DecisionCache
from repro_torch.measure.fingerprint import (
    system_description,
    system_fingerprint,
    type_fingerprint,
)
from repro_torch.measure.production import DECISIONS_FILENAME, production_communicator
from repro_torch.measure.store import (
    COMPATIBLE_FORMATS,
    STORE_FORMAT,
    ParamsStore,
    ci_params_path,
    default_store,
    h100_params_path,
    load_ci_params,
    load_h100_params,
    load_or_calibrate,
)

__all__ = [
    "COMPATIBLE_FORMATS",
    "DECISIONS_FILENAME",
    "DECISIONS_FORMAT",
    "Decision",
    "DecisionCache",
    "ParamsStore",
    "STORE_FORMAT",
    "calibrate_params",
    "ci_params_path",
    "default_store",
    "fit_latency_bandwidth",
    "h100_params_path",
    "load_ci_params",
    "load_h100_params",
    "load_or_calibrate",
    "measure_copy_table",
    "measure_pack_table",
    "measure_compress_table",
    "measure_link_class_tables",
    "measure_stencil_table",
    "measure_unpack_table",
    "measure_wire_table",
    "measure_wire_tables",
    "production_communicator",
    "system_description",
    "system_fingerprint",
    "time_fn",
    "type_fingerprint",
]
