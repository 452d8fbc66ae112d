"""Planning: logical plans from the AST, physical plans, and the request
IR shipped to the coprocessor (expressions, CopDAG, FragmentDAG)."""
