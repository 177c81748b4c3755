"""Research workloads of the port."""
