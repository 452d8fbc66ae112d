"""Request IR shipped to the coprocessor: expressions, CopDAG, FragmentDAG."""
