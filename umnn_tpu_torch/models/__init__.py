"""Flow models: the UMNN-MAF block and the flow."""
