"""dql_grasping_lib: convnet helpers shared by grasping-style critics."""
