"""The port's control plane (counterpart of ``repro/core``): MIG profiles,
leaves and GPU state, jobs, the Flex-MIG placement policy, the scheduler,
the JCT model and the traces; the operation modes (FM, DM, SM), the
discrete-event simulator and its metrics; the MIG-aware registry, the job
executor and the aggregation of leaves into a job's layout."""
