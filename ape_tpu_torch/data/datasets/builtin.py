"""The builtin dataset names the config files read at load time (counterpart
of ``ape_tpu/data/datasets/builtin.py``). The registrations of that module
wait (ROADMAP Queue 1 #3): a config that names a builtin dataset finds it in
the port's catalog only where it registers it itself, as
``configs/common/data/coco.py`` does.
"""

# the ODinW-13 eval split names exactly as the reference evaluates them
# (configs/common/data/odinw13_instance_lsj1024.py:88-102 — _test splits,
# PascalVOC on _val)
ODINW_13_TEST = [
    "odinw_AerialMaritimeDrone_large_test",
    "odinw_Aquarium_Aquarium_Combined.v2-raw-1024.coco_test",
    "odinw_CottontailRabbits_test",
    "odinw_EgoHands_generic_test",
    "odinw_NorthAmericaMushrooms_North_American_Mushrooms.v1-416x416.coco_test",
    "odinw_Packages_Raw_test",
    "odinw_PascalVOC_val",
    "odinw_pistols_export_test",
    "odinw_pothole_test",
    "odinw_Raccoon_Raccoon.v2-raw.coco_test",
    "odinw_ShellfishOpenImages_raw_test",
    "odinw_thermalDogsAndPeople_test",
    "odinw_VehiclesOpenImages_416x416_test",
]
