"""Physical drone parameters and derived constants.

Own copy of the JAX package's `params.py` (numpy and the standard library
only), kept here so that this package imports nothing of the JAX one.
Parameters live in a frozen, hashable dataclass; kernels and tensor code
read its plain Python floats and convert to the working dtype at use.

Values are the physical constants published in the reference URDFs
(gym_pybullet_drones/assets/{cf2x,cf2p,racer}.urdf, the `<properties>` tag
and inertial blocks).  `from_urdf` / `to_urdf` give file-level parity for
users with their own URDFs.
"""
from __future__ import annotations

import math
import dataclasses
import xml.etree.ElementTree as etxml

import numpy as np

from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel

G = 9.8  # gravitational acceleration, reference BaseAviary.py:74


@dataclasses.dataclass(frozen=True)
class DroneParams:
    """Per-model physical constants + derived quantities.

    All fields are plain Python floats/tuples so the dataclass is hashable and
    can key caches; kernels convert to the working dtype at use.

    Derived-constant formulas follow reference BaseAviary.py:116-128.
    """

    model: DroneModel
    # --- URDF <properties> ---
    m: float            # mass [kg]
    l: float            # arm length [m]
    thrust2weight: float
    ixx: float
    iyy: float
    izz: float
    kf: float           # thrust coefficient [N/RPM^2]
    km: float           # torque coefficient [N*m/RPM^2]
    collision_h: float
    collision_r: float
    collision_z_offset: float
    max_speed_kmh: float
    gnd_eff_coeff: float
    prop_radius: float
    drag_coeff_xy: float
    drag_coeff_z: float
    dw_coeff_1: float
    dw_coeff_2: float
    dw_coeff_3: float
    # prop link offsets in the body frame ((x, y, z) per prop, from the URDF
    # prop{0..3}_link inertial origins); used for analytic prop FK in the
    # ground-effect model and the PYB-mode force application points.
    prop_offsets: tuple[tuple[float, float, float], ...]

    # ------------------------------------------------------------------
    # Derived constants (reference BaseAviary.py:116-128)
    # ------------------------------------------------------------------
    @property
    def gravity(self) -> float:
        return G * self.m

    @property
    def hover_rpm(self) -> float:
        return math.sqrt(self.gravity / (4 * self.kf))

    @property
    def max_rpm(self) -> float:
        return math.sqrt((self.thrust2weight * self.gravity) / (4 * self.kf))

    @property
    def max_thrust(self) -> float:
        return 4 * self.kf * self.max_rpm**2

    @property
    def max_xy_torque(self) -> float:
        if self.model == DroneModel.CF2P:
            return self.l * self.kf * self.max_rpm**2
        # CF2X and RACE share the X-configuration formula
        return (2 * self.l * self.kf * self.max_rpm**2) / math.sqrt(2)

    @property
    def max_z_torque(self) -> float:
        return 2 * self.km * self.max_rpm**2

    @property
    def gnd_eff_h_clip(self) -> float:
        return 0.25 * self.prop_radius * math.sqrt(
            (15 * self.max_rpm**2 * self.kf * self.gnd_eff_coeff) / self.max_thrust
        )

    @property
    def speed_limit(self) -> float:
        # velocity-command envs: reference VelocityAviary.py:78 / BaseRLAviary.py:95
        return 0.03 * self.max_speed_kmh * (1000 / 3600)

    @property
    def drag_coeff(self) -> tuple[float, float, float]:
        return (self.drag_coeff_xy, self.drag_coeff_xy, self.drag_coeff_z)

    @property
    def J(self) -> np.ndarray:
        return np.diag([self.ixx, self.iyy, self.izz])

    @property
    def J_inv(self) -> np.ndarray:
        return np.diag([1.0 / self.ixx, 1.0 / self.iyy, 1.0 / self.izz])

    @property
    def init_z(self) -> float:
        # default spawn height, reference BaseAviary.py:197
        return self.collision_h / 2 - self.collision_z_offset + 0.1


# Shared Crazyflie 2.x aerodynamic properties (cf2x.urdf / cf2p.urdf line 5)
_CF2_COMMON = dict(
    m=0.027,
    l=0.0397,
    thrust2weight=2.25,
    kf=3.16e-10,
    km=7.94e-12,
    collision_h=0.025,
    collision_r=0.06,
    collision_z_offset=0.0,
    max_speed_kmh=30.0,
    gnd_eff_coeff=11.36859,
    prop_radius=2.31348e-2,
    drag_coeff_xy=9.1785e-7,
    drag_coeff_z=10.311e-7,
    dw_coeff_1=2267.18,
    dw_coeff_2=0.16,
    dw_coeff_3=-0.11,
)

CF2X = DroneParams(
    model=DroneModel.CF2X,
    ixx=1.4e-5,
    iyy=1.4e-5,
    izz=2.17e-5,
    prop_offsets=(
        (0.028, -0.028, 0.0),
        (-0.028, -0.028, 0.0),
        (-0.028, 0.028, 0.0),
        (0.028, 0.028, 0.0),
    ),
    **_CF2_COMMON,
)

CF2P = DroneParams(
    model=DroneModel.CF2P,
    ixx=2.3951e-5,
    iyy=2.3951e-5,
    izz=3.2347e-5,
    prop_offsets=(
        (0.0397, 0.0, 0.0),
        (0.0, 0.0397, 0.0),
        (-0.0397, 0.0, 0.0),
        (0.0, -0.0397, 0.0),
    ),
    **_CF2_COMMON,
)

RACE = DroneParams(
    model=DroneModel.RACE,
    m=0.830,
    l=0.109,
    thrust2weight=4.17,
    ixx=3.113e-3,
    iyy=3.113e-3,
    izz=3.113e-3,
    kf=8.47e-9,
    km=2.13e-11,
    collision_h=0.025,
    collision_r=0.06,
    collision_z_offset=0.0,
    max_speed_kmh=200.0,
    gnd_eff_coeff=11.36859,
    prop_radius=12.7e-2,
    drag_coeff_xy=9.1785e-7,
    drag_coeff_z=10.311e-7,
    dw_coeff_1=2267.18,
    dw_coeff_2=0.16,
    dw_coeff_3=-0.11,
    prop_offsets=(
        (0.0850, 0.0675, 0.0),
        (-0.0850, 0.0675, 0.0),
        (-0.085, -0.0675, 0.0),
        (0.085, -0.0675, 0.0),
    ),
)

_BY_MODEL = {DroneModel.CF2X: CF2X, DroneModel.CF2P: CF2P, DroneModel.RACE: RACE}


def get_params(model: DroneModel | str) -> DroneParams:
    """Look up the built-in parameter table for a drone model."""
    if isinstance(model, str):
        model = DroneModel(model)
    return _BY_MODEL[model]


def from_urdf(path: str, model: DroneModel = DroneModel.CF2X) -> DroneParams:
    """Parse a gym-pybullet-drones-format URDF into a DroneParams.

    File-format parity with reference BaseAviary._parseURDFParameters()
    (BaseAviary.py:982-1014) plus extraction of the prop link offsets that the
    reference obtains implicitly through PyBullet forward kinematics.
    """
    root = etxml.parse(path).getroot()
    props = root[0].attrib
    base_link = root[1]
    inertia = base_link[0][2].attrib
    mass = float(base_link[0][1].attrib["value"])
    collision_geom = base_link[2][1][0].attrib
    collision_origin = [float(s) for s in base_link[2][0].attrib["xyz"].split(" ")]

    prop_offsets = []
    for link in root.iter("link"):
        name = link.attrib.get("name", "")
        if name.startswith("prop") and name.endswith("_link"):
            xyz = link[0][0].attrib["xyz"].split(" ")
            prop_offsets.append(tuple(float(s) for s in xyz))

    return DroneParams(
        model=model,
        m=mass,
        l=float(props["arm"]),
        thrust2weight=float(props["thrust2weight"]),
        ixx=float(inertia["ixx"]),
        iyy=float(inertia["iyy"]),
        izz=float(inertia["izz"]),
        kf=float(props["kf"]),
        km=float(props["km"]),
        collision_h=float(collision_geom["length"]),
        collision_r=float(collision_geom["radius"]),
        collision_z_offset=collision_origin[2],
        max_speed_kmh=float(props["max_speed_kmh"]),
        gnd_eff_coeff=float(props["gnd_eff_coeff"]),
        prop_radius=float(props["prop_radius"]),
        drag_coeff_xy=float(props["drag_coeff_xy"]),
        drag_coeff_z=float(props["drag_coeff_z"]),
        dw_coeff_1=float(props["dw_coeff_1"]),
        dw_coeff_2=float(props["dw_coeff_2"]),
        dw_coeff_3=float(props["dw_coeff_3"]),
        prop_offsets=tuple(prop_offsets[:4]),
    )


def to_urdf(params: DroneParams, path: str) -> str:
    """Write a DroneParams as a gym-pybullet-drones-format URDF file.

    Inverse of `from_urdf` (element layout per reference
    BaseAviary._parseURDFParameters, BaseAviary.py:982-1014): a
    `<properties>` tag with the aerodynamic constants, a base link with
    inertial + visual + collision-cylinder blocks, and one link per prop
    carrying its body-frame offset.  For users exporting customized models.
    """
    p = params
    prop_links = "\n".join(
        f"""  <link name="prop{i}_link">
    <inertial>
      <origin rpy="0 0 0" xyz="{ox!r} {oy!r} {oz!r}"/>
      <mass value="0"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
  </link>
  <joint name="prop{i}_joint" type="fixed">
    <parent link="base_link"/>
    <child link="prop{i}_link"/>
  </joint>"""
        for i, (ox, oy, oz) in enumerate(p.prop_offsets))
    xml = f"""<?xml version="1.0" ?>
<robot name="{p.model.value}">
  <properties arm="{p.l!r}" kf="{p.kf!r}" km="{p.km!r}"
    thrust2weight="{p.thrust2weight!r}" max_speed_kmh="{p.max_speed_kmh!r}"
    gnd_eff_coeff="{p.gnd_eff_coeff!r}" prop_radius="{p.prop_radius!r}"
    drag_coeff_xy="{p.drag_coeff_xy!r}" drag_coeff_z="{p.drag_coeff_z!r}"
    dw_coeff_1="{p.dw_coeff_1!r}" dw_coeff_2="{p.dw_coeff_2!r}"
    dw_coeff_3="{p.dw_coeff_3!r}"/>
  <link name="base_link">
    <inertial>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <mass value="{p.m!r}"/>
      <inertia ixx="{p.ixx!r}" ixy="0" ixz="0" iyy="{p.iyy!r}" iyz="0" izz="{p.izz!r}"/>
    </inertial>
    <visual>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <geometry>
        <cylinder length="{p.collision_h!r}" radius="{p.collision_r!r}"/>
      </geometry>
    </visual>
    <collision>
      <origin rpy="0 0 0" xyz="0 0 {p.collision_z_offset!r}"/>
      <geometry>
        <cylinder length="{p.collision_h!r}" radius="{p.collision_r!r}"/>
      </geometry>
    </collision>
  </link>
{prop_links}
  <link name="center_of_mass_link">
    <inertial>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <mass value="0"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
  </link>
  <joint name="center_of_mass_joint" type="fixed">
    <parent link="base_link"/>
    <child link="center_of_mass_link"/>
  </joint>
</robot>
"""
    with open(path, "w") as f:
        f.write(xml)
    return path


def asset_path(model: DroneModel | str) -> str:
    """Path of the in-package URDF asset for `model` (cf2x/cf2p/racer): the
    port's own copies of the JAX package's, which `from_urdf` parses back
    to the built-in tables."""
    import os
    model = DroneModel(model)
    return os.path.join(os.path.dirname(__file__), "assets",
                        f"{model.value}.urdf")


def obstacle_asset_path(name: str) -> str:
    """Path of an in-package obstacle URDF asset (e.g. 'architrave', 'box');
    the port's own copies of the JAX package's assets."""
    import os
    return os.path.join(os.path.dirname(__file__), "assets", f"{name}.urdf")


def load_obstacle_urdf(path: str, position=(0.0, 0.0, 0.0)) -> tuple:
    """Parse an obstacle URDF's collision geometry into an engine obstacle.

    Returns the tuple format consumed by the PYB-mode steppers
    (ops/rigid_body.pyb_step `obstacles=`): `(x, y, z, r)` for a sphere,
    `(x, y, z, hx, hy, hz)` for a box (center + half extents).  A cylinder
    is converted to its bounding box.  `position` places the body in the
    world (role of the basePosition argument of the reference's
    p.loadURDF, e.g. examples/debug.py:19-20).

    Limitations: only the FIRST link's first collision (or visual) geometry
    is used and its <origin rpy> is ignored — shapes are placed axis-aligned
    at base position + collision <origin xyz>.  Multi-link or rotated
    obstacle URDFs need explicit obstacle tuples instead.
    """
    root = etxml.parse(path).getroot()
    geom = None
    origin = (0.0, 0.0, 0.0)
    for tag in ("collision", "visual"):   # visual-only URDF: the visual
        for link in root.iter("link"):
            block = link.find(tag)
            if block is not None:
                geom = block.find("geometry")[0]
                og = block.find("origin")
                if og is not None and "xyz" in og.attrib:
                    origin = tuple(
                        float(s) for s in og.attrib["xyz"].split())
                break
        if geom is not None:
            break
    if geom is None:
        raise ValueError(f"no collision/visual geometry in {path}")
    x, y, z = (float(v) + o for v, o in zip(position, origin))
    if geom.tag == "sphere":
        return (x, y, z, float(geom.attrib["radius"]))
    if geom.tag == "box":
        sx, sy, sz = (float(s) for s in geom.attrib["size"].split())
        return (x, y, z, sx / 2, sy / 2, sz / 2)
    if geom.tag == "cylinder":
        r = float(geom.attrib["radius"])
        h = float(geom.attrib["length"])
        return (x, y, z, r, r, h / 2)
    raise ValueError(f"unsupported obstacle geometry <{geom.tag}> in {path}")
