"""repro_torch.launch — process groups and the command-line workloads.

Importing a module of this package starts no process group: that
happens in :func:`repro_torch.launch.procgroup.init_process_group`, or
in a launcher's ``main``.
"""
